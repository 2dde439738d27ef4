"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Drives volprim_tpu_torch's render path (synthetic 262,144-primitive surface
scene -> build_state -> render_state, 512x512 film, 2 spp, the headline
configuration of bench.py), its training step (the same scene, 1 spp,
bench.py's train configuration, L1 loss, backward, BoundedAdam), the
3DGS-asset path (PLY, cameras.json, the two example CLIs) and the
volume-fitting path (tomography, grid volumes, two more CLIs), and checks
the hand-written CUDA compositor kernels on the way, in phases that each
print one line:

1. probe: the card, its power limit, TF32 off;
2. build: nvcc builds the nine sources of csrc/ (composite3_fwd/_bwd, the
   forward's timing ablations composite3_fwd_abl, ffwalk,
   composite_fwd/_bwd, composite2_fwd/_bwd, clone) from this checkout, one
   process each, started together, and prints ptxas's registers, stack and
   spill bytes for every instantiation of the v3 compositors (k, band,
   threads), of the v1 / v2 forward and backward (version, k, threads) and
   of the walk (slots per lane: 1, 2, 0 for shared memory); it fails if a
   k = 4 instantiation of the path (v3 unbanded, the v1 / v2 forward and
   backward; v1's forward has one build per block size, which takes every
   k) at 256 or 512 threads spills, or the walk's k <= 32 one
   (spill_gated);
3. kernel: the forward kernel against its plain PyTorch version at the
   headline shapes (T=64 tiles, R=512 rays, S=2048 and 8192 columns, seg
   256, k=4, bf16 SH, compaction on and off), with CUDA-event timings;
4. main path: the frame through the kernel (launch counts, frame time,
   Mrays/s, peak memory, mean radiance), then the kernel against its plain
   version on the inputs that frame gave it;
5. quality: a 1-spp unjittered frame against the exact-order integrator on
   a fixed 4096-pixel subsample (PSNR);
6. bwd_kernel: the backward kernel against its plain version on synthetic
   inputs (T=64, R=256 and 512, S=2048, seg 256, k=4, compaction on and
   off, unbanded and at order_band 8, with the banded forward checked
   beside it) with numpy-made cotangents; here and wherever the backward
   is checked (phases 7, 19 and 20), a second launch on the same inputs
   must give bit-identical gpf and gsh;
7. train_step: the full-width train step (launch counts, finite nonzero
   gradients of all five parameters, step time, peak memory), then the
   forward and the backward kernel against their plain versions on that
   step's own inputs;
8. train_loop: eight steps of the refine protocol through train.train_step
   (perturbed opacities and SH against a 4-spp render of the scene);

the path tracer's forward render (models.render -> prb.radiance with
PRBConfig(walk_backend="pallas"), the 4096-primitive plume under the
procedural sky, examples/render_volume.py's camera at 512x512, 1 spp),
whose free-flight walk is the hand-written kernel csrc/ffwalk.cu (built in
phase 2 with the compositors):

9. ffwalk_kernel: the walk's wrapper ffwalk.walk (which launches the
   kernel) against its plain version on the tables the port collects for
   65,536 plume camera rays, in eight variants (ffwalk.WALK_VARIANTS: K' /
   k / windows 256/32/4, 128/8/4, 64/64/1, surface caps on half the rays,
   a finite budget, the solver disabled, the walk started at the jump
   boundary, long intervals open across windows);
10. prb_frame: one counted frame whose walk launches are recorded and then
   replayed through ffwalk.walk, each held against the plain version on its
   own inputs (bounce 0's launches and the largest later one are printed;
   walk_ms_per_frame sums their launch_ms, walk_kernel_ms_per_frame the
   kernel's own device time from torch.profiler), then a warm-up and three
   timed frames;
11. prb_absorbing: the plume with albedo 0 under a unit sky, where each
   ray's radiance is 1 with probability T: the mean radiance of the
   512x512 unjittered rays against the mean of prb.transmittance, within 4
   standard errors;

and the tiled renderer through the v1 and v2 compositors (rf_tiled
backend="pallas" / "pallas2", the headline scene, film and culls with the
knobs those backends read, V12; csrc/composite_fwd.cu, composite_bwd.cu,
composite2_fwd.cu, composite2_bwd.cu):

12. v1_frame: the 2-spp frame (launch counts, frame time, Mrays/s, peak
    memory, PSNR of a 1-spp unjittered frame against the exact-order
    integrator on phase 5's subsample and against phase 5's fused frame),
    then every forward launch's recorded inputs replayed through the
    wrapper against the plain version (ATOL / RTOL and KILL_FLIP), then
    the forward on synthetic tiles (synthetic12: S = 2048, seg 256, a
    third of the columns at opacity 0 among the others and a neutral tail)
    at max_depth 128 and 8, held the same way: every block size (R = 256,
    512, 1024 rays) at k = 4, R = 256 at k = 1, 9 and 16, and for v1 a set
    whose blocks find different live SH counts (fwd12_cases); the phase
    line carries the forward's ptxas rows and its synthetic errors;
13. v1_train_step: the full-width train step (1 spp, L1 against a zero
    image; finite nonzero gradients of all five parameters, step time,
    peak memory), then its forward and backward launches' inputs replayed
    against the plain versions, the backward held to an f64 run of the
    plain version that takes the f32 versions' a, b, c and q (yard12,
    compare_grads12, KILL_FLIP columns excused and counted), and again
    with max_depth 8; at both caps two backward launches on the same
    inputs must give torch.equal gpf, gcol and gsh; then every block size
    of the backward (R = 256, 512, 1024 rays) on synthetic tiles
    (synthetic12: S = 2048, seg 256, k = 4) held the same way; the phase
    line carries the backward's ptxas rows and, as phases 12 and 14 do,
    the hits under the cap split by alpha > 0 and alpha = 0 (work12);
14. v2_frame and 15. v2_train_step: the same through backend="pallas2".
The frames and steps are checked against their plain versions, not
against a quality limit: v1 and v2 compute q = c - b^2 / a, which cancels
at this scene's scale ratios.

Then the per-stage profiler's path (volprim_tpu_torch.tools.profile_rf)
with its DMA-floor probe (csrc/clone.cu), and the order band of the v3
compositors:

16. clone: the probe against its plain version at the profiler's
    kernel-stage tile blocks (CLONE: 1024 tiles of 256 rays, 2048 columns,
    12 bf16 SH rows) and at 4x the columns: every element equal, its time
    beside its bytes bound and torch.sum over the same tensors, and the
    4S / S time ratio, which must reach 1.5 (a probe whose reads were
    optimised away would not grow);
17. profile_rf: the profiler in-process at its defaults plus the stage
    stops, the coarse cull, the probe, the segment statistics and the
    forward's eight timing ablations (abl_*: each stage's time is printed;
    their results are wrong by design and nothing checks them; every stage
    line printed, each kernel of its path launched), then one frame
    of its configuration (refine 0.125) with every compositor launch, base
    and refine pass, replayed against the plain version, and its PSNR
    against phase 5's exact subsample beside refine 0 (it must not drop);
18. band_frame: bench.py's two order-band frames (BAND, 4096 and 8192
    candidates, band 16): every forward launch replayed against the plain
    version (ATOL / RTOL, KILL_FLIP; walked and live segments equal), the
    median of 10 frames, peak memory, and PSNR against phase 5's exact
    subsample, which must exceed the same frame's unbanded;
19. band_train_step: phase 7's step with order_band 16, its forward and
    backward launches replayed (the backward against the f64 yardstick,
    compare_grads);
20. quat_drift_step: phase 7's step with compaction off and every
    quaternion scaled to norm 0.9 (pack_fused_features does not normalise
    them, so each ellipsoid outgrows row 14's radius): the kernels' warp
    cull alone stands between a column and the rays. Both kernels must
    give bit-identical outputs with row 14 as packed and set to +inf (no
    cull: a dropped hit would change them), and both must agree with their
    plain versions as in phase 19 (the backward's KILL_FLIP ray, whose
    weight lies on log(beta_kill), is excused and counted: kill_flips).

Then the 3DGS-asset path (the PLY and cameras.json the port writes itself,
rf_tiled's xla backend, emitters, the Epanechnikov kernel and the two
example CLIs), on the headline scene at full width:

21. asset_io: save_ply of the scene (under build/chip_smoke_asset), then
    load_ply through the native parser and through numpy: bit-equal to
    each other and within JAX's round-trip tolerances of the scene; the
    headline camera and 7 orbit cameras through JSONCameraSpecsIO; the
    seconds of each step;
22. xla_frame: the V12 frame through backend="xla" (plain PyTorch): median
    of 10, peak memory, PSNR against phase 5's exact subsample (>= 20 dB);
    the same frame through the v1 kernel within rtol 1e-3 / atol 2e-3
    (JAX's test_pallas_backend_matches_xla), or else, where q = c - b^2/a
    cancels, both held to the v1 plain version in f64 on the same
    shortlists (RMS within 2x, largest within 4x of the v1 kernel's
    deviation); the Epanechnikov
    frame against the exact integrator's Epanechnikov subsample (>= 20
    dB); order_band 16 at 4096 candidates not below the same frame
    unbanded;
23. xla_train_step: the train step with V12's knobs through the xla route:
    finite nonzero gradients of all five parameters, step time and peak
    memory, each gradient within 2e-3 of its maximum of the v1 kernel's,
    or else held to the yardstick of phase 22: opacities and SH by its
    rule, centers, scales and quats (whose plain-autograd sums cancel in
    f32) by their projection on the f64 gradient (within 0.3 of 1) and
    an RMS deviation within 20x the v1 kernel's; then the Epanechnikov
    step;
24. emitter: the headline fused frame, the xla frame and the headline
    fused frame with early_exit and compaction off (the early-exit walk;
    srgb_primitives off, 1 spp, pixel centers) with and without
    ConstantEmitter(ones): their difference equals, pixel by pixel, the
    beta the compositor returned for that pixel's ray (placed by its
    direction) within 1e-6;
25. cli: render_3dg_asset and refine_3dg_dataset in subprocesses on phase
    21's files: the tiled Gaussian render (fused kernel; its EXR equal to
    an in-process render of the same configuration, whose forward launches
    are counted and replayed against the plain version), the exact
    Epanechnikov render with a white background, and the refine through
    the xla route (Epanechnikov) and the fused kernels (Gaussian, whose
    in-process step's forward and backward launches are replayed) against
    references rendered in-process from the unperturbed scene, starting
    from phase 8's perturbed opacities and SH: the losses must fall and
    the refined asset load back whole; each CLI's wall time.

Then the volume-fitting path (models/tomography.py, models/gridvol.py, the
optimize_volume and render_asset CLIs), plain PyTorch with no kernel of its
own, at optimize_volume's full widths (8 ring cameras at 256x256, a 16^3
lattice, procedural_smoke at 48^3):

26. tomography_frame: the batch sensor at 1 spp through the tomography
    integrator (2.15e9 ray-primitive pairs, sigma_t 0.5, a constant
    emitter): median of 5 and peak memory beside the pair budget
    _TOMO_PAIRS in force; the f32 radiance of 4,096 pixel-centre rays
    within rtol 1e-4 / atol 1e-6 of the same function in f64; one
    Gaussian's transmittance within 1e-3 of its closed form;
27. tomography_step: the scattering reference (4 spp, cut from 32), then 8
    optimize steps (cut from 64) through the CLI's own train_step
    (render_batch, L1, backward(), BoundedAdam): median step time of steps
    2-4 and peak memory; the loss must fall and sigma_t stay in [1e-8,
    1e-3] (with --out, a profile of two more steps);
28. gridvol_reference: the scattering reference (its time at 4 spp from
    phase 27, which renders it; the device kernels and device ms of one
    sample, from torch.profiler at bounce caps 1 and 2, each bounce being
    the same kernels on the same shapes; the device's idle share) and the
    furnace (a uniform grid at albedo 1, 4,096 rays, mean within 0.03 of
    1);
29. volume_clis: optimize_volume in a subprocess (--cam_count 8 --cam_res
    256 --volprim_count 16 --iterations 8 --ref_spp 4), whose PSNR must
    rise, then render_asset on its asset and on the same scene written by
    save_reference_asset: finite images in [0, 1]; each wall time.

Then the rest of the path tracer (the xla window walk, the sequential walk
with its re-collection rounds, cluster collection, coeff_gemm, the
Epanechnikov kernel, triangle-mesh surfaces with BSDFs, the render_volume
CLI), on phase 10's plume, camera and sky; the pallas runs' walk launches
go through csrc/ffwalk.cu on tables no earlier phase gives it:

30. prb_xla_frame: phase 10's frame through walk_backend="xla": median of
    3, peak memory, the mean radiance within 4 standard errors of phase
    10's frame; bounce 0 per ray: free_flight on the 262,144 camera rays
    with one xi under both backends, the rays that decide differently at
    most WALK_DIFF_SHARE of them;
31. prb_budgets and prb_walk_path (one line a path): count_intervals on
    the camera rays (percentiles of the need) and suggest_budgets' config;
    under that config the frame on the jump path (pallas), with jump=False
    and with use_clusters, each under both backends, with coeff_gemm
    (pallas) and with the Epanechnikov kernel (xla): each pallas run's walk
    launches recorded and replayed against the plain version (the
    sequential walk's windows from t = 0, the cluster tables' budgets),
    their launches and walk_work (the xla paths at XLA_SEQ_WIDTH^2, one
    frame: 49-63 s at 512^2 on an H100 80GB HBM3 at 700 W); each frame's
    time, mean, bounce-0 dead
    share and distance from the jump frame's mean in standard errors;
    prb_walk_twins: the paths that kill the same rays (TWIN_PATHS) held to
    each other, means within 4 standard errors and (the fused pairs)
    bounce 0 per ray;
32. prb_surfaces: the plume in a Cornell box (box_mesh: Principled walls,
    the left one left out) at 512^2, 1 spp, pallas: its walk launches, with
    finite surface caps, replayed; the frame's time; the white furnace
    (a 512-primitive plume inert over a white diffuse floor under a unit
    sky) within 4 standard errors of 1;
33. render_volume_cli: the CLI in a subprocess at 512^2, RV_SPP spp (cut
    from 64), with --walk_backend xla --auto_budget and with
    --walk_backend pallas: finite EXRs whose means lie within 4 standard
    errors of each other; each wall time.

Then the tooling (volprim_tpu_torch.tooling and its two CLIs; plain
PyTorch, no kernel of its own but the walk's under walk_backend="pallas"):

34. radiosity_fit (one line a BSDF, diffuse and principled):
    fit_radiosity_bsdf's scene and defaults (64 points, 96 wi, 1 wo, lr
    2e-2, procedural_sky(32, 64)) for RAD_ITERS iterations (cut from 60),
    through the CLI's own setup and step: the step time (median of
    RAD_TIMED steps through utils.benchmark.measure), peak memory, with
    --out the device's idle share (torch.profiler, two steps); the loss
    finite at every step and the final base_color MAE below the initial
    one; then one compute_loss's cache queries (eval_li_mat, eval_lo) with
    walk_backend="pallas": its walk launches (rays spawned 1e-3 off the
    surfaces, finite surface caps, the zero-density medium) recorded and
    replayed against the plain version, 0 rays differing, and the mean of
    li_w within 4 standard errors of the xla walk's;
35. sh_fit_visualizer: fit_sh_on_mesh on phase 34's diffuse ground-truth
    mesh at its defaults (degree 3, res 15, ray_budget 2^20): time and
    rays; the reconstruction at 8 interior directions of vertex 0 within
    0.15 of direct queries (tests/test_tooling.py's self-consistency);
    render_mesh_attribute of base_color at 512^2: time, finite, a white
    background corner;
36. generate_dataset_cli: the CLI in a subprocess on phase 21's PLY at its
    default 256^2 film and 100,000 points, with --subdivisions 0 (12
    cameras, cut from 42) and --spp DS_SPP (cut from 8), sized beforehand
    from phase 5's exact_s: wall time and render time a camera; the
    layout (11 train and 1 test frames, images as .png and .npy, the
    points), finite images in [0, inf), the transforms equal to the rig's.

Then data parallelism (volprim_tpu_torch.parallel: ranks are processes,
each rendering its block of tiles or rays; the compositor kernels of
phases 4 and 7 run on the blocks):

37. data_parallel (one line a rank): this process renders the TRAIN frame
    and the HEADLINE frame of the headline scene (2 spp, jittered) and
    takes train.train_step (TRAIN, L1 against a zero image) and the
    dryrun's batch-sensor step (render_batch with rf.radiance on the
    refine CLI's 8 cameras of 64^2, parallel.sharded_grad_step,
    BoundedAdam) twice each as a single process, then starts DP_WORLD = 2
    ranks of this script with gloo on the one card (chip_smoke.py
    --dp_rank R; NCCL refuses two ranks on one device), then one NCCL
    rank; each loads the kernels phase 2 built and does the same on the
    mesh: the TRAIN frame bit-identical, the HEADLINE frame (budget
    classes chosen per block) above 25 dB from the single process's,
    every gradient within DP_GRAD_RTOL in norm and the opacities per
    element, the parameters after each step equal on every rank, both
    kernels launched; per rank the frames' and steps' times (CUDA
    events), the all-gather and all-reduce alone at the frame's and the
    steps' sizes, the launches and peak memory. A rank that fails or
    outlasts DP_TIMEOUT fails the run.

Then the last two pieces of the JAX package: the fused forward's early-exit
walk and the path tracer's stage profilers:

38. early_exit (and one early_exit_launch line a launch): the refine CLI's
    tiled configuration (fused, early_exit, no compaction) on phase 25's 8
    cameras at 64^2 and the profiler frame's (tools/profile_rf at its
    defaults: 512^2, 2 spp, refine 0.125) on the headline scene, each
    driven once with the counts set to 0 just before and read just after;
    every launch replayed with early_exit on and off against the plain
    versions (L within ATOL / RTOL and KILL_FLIP, walked and live equal per
    tile, beta under early exit as EE_BETA_RTOL says), the kernel's
    ms with the flag on and off, the plain version's, the bound on the
    segments the early-exit walk reads, and the segments walked against
    live. Some launch must hold tiles that stop early and tiles that walk
    every live segment, or phase 3's synthetic tiles with every live
    opacity at 0.99 are added (EE_SYNTH);
39. prb_profiler: tools/profile_prb (--quick plus its walk=pallas rows) and
    tools/ff_attrib in-process at PRB_PROFILE_RES^2 with PRB_PROFILE_REPS
    reps, their rows and summaries printed: the walk=pallas rows must have
    launched csrc/ffwalk.cu, and each _FF_STOP stage must take no longer
    than the full free_flight by more than the two rows' spread of reps.

Then the tiled renderer's quality studies (volprim_tpu_torch.tools, each
run in-process, its printed lines echoed and its JSON line read back):

40. quality_studies: convergence_eval through the fused backend at
    QS_ITERS steps (cut from 150; its forward and backward kernels launched
    once a step each), analyze_rf at its defaults (the headline scene at
    512^2: need, survival, PSNR by budget against an exact reference made
    on the card), diag2m's default configurations and noise floor on
    QS_DIAG_PRIMS primitives (cut from 2,097,152); every JSON line must
    parse and equal what the tool returned, every PSNR be finite. The
    compositor launches of the fit and of analyze_rf's frames are recorded:
    the first and last steps' forward and backward launches and each
    budget's first frame are replayed against the plain versions at phase
    7's tolerances, and each budget's other timed frames must have had the
    same inputs. The fit must end above its initial scene's held-out PSNR,
    and both of analyze_rf's frames (2,048 and 8,192 candidates) score at
    least QS_PSNR_DB against the card-made exact reference; the phase's
    seconds.

Then the root studies (volprim_tpu_torch.tools, in-process as in phase 40):

41. root_studies: refine_truck at RS_SPLATS splats, RS_RES^2, RS_SPP spp
    and RS_ITERS steps (cut from 1,048,576, 256^2, 4 and 256; its 8 + 2
    ring cameras, --perturb strong, the workdir RS_DIR made anew): the
    ground truth and held-out scores by the exact renderer made on the
    card, training through the refine CLI's fused compositor (early exit
    on), the tiled evaluation; truck_bound on its held-out images at the
    same size and spp; band262k at its defaults (262,144 primitives, 512^2,
    all eight configurations). refine_truck's forward and backward
    launches are recorded and split by the tool's own counts: the first
    and last steps' launches (a forward and a backward per camera) and
    each tiled evaluation's first launch are replayed against the plain
    versions at phase 7's tolerances, and the first step's bounds are
    computed. The CLI's loss must fall and the refined asset's tiled
    held-out PSNR lie above its initial asset's (the exact-scored PSNRs
    are recorded, not gated); truck_bound's 8,192 candidates must bound no
    lower than 2,048; every band262k row must score at least RS_PSNR_DB
    against the card-made exact reference and mc4096-csort-band16 not
    below mc4096; the phase's seconds.

Then the total seconds, a JSON line with each kernel's numbers (the walk's
with its launches, kernel ms and bound on the sequential, cluster,
coeff_gemm, surface-capped and radiance-cache paths and its launches in
phase 39; the compositors' with the launches of phase 37's ranks, by
backend and rank; the forward's with phase 38's early-exit walk; both
with phase 41's launches and its first refine step's kernel, plain and
bound times), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. There is no CPU mode: without a CUDA card it exits with an
error. ``--out DIR`` also writes the details and torch.profiler tables of
two tiled frames, two train steps, two path-traced frames and two
tomography steps there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import inspect
import json
import math
import os
import re
import socket as socketlib
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerance of a kernel against its plain version on the card: native
# expf/log1pf and another summation order than torch's cumsum/matmul.
ATOL, RTOL = 1e-4, 1e-3
# ...except where a ray's log-transmittance lands within rounding of
# log(beta_kill): the two versions then disagree on one emission weight
# (at most beta_kill times the emission). Allowed on at most this share of
# the rays; every such ray is counted and printed.
KILL_FLIP_SHARE = 1e-4
KILL_FLIP_ATOL = 0.05
# A backward's KILL_FLIP: a hit whose log-weight lw, in the plain version's
# own run, lies within this of log(beta_kill) (some 40 f32 ulps at
# log(0.01); the two versions' sums of log1p(-alpha) differ by a few) may be
# taken alive by one version and dead by the other. Its g_lw then differs,
# and with it g_logt, a suffix sum, at that hit and every earlier hit of the
# ray: band_check excuses those columns of the ray's tile, if the rays of
# the tiles that needed it are at most KILL_FLIP_SHARE of the rays (at
# least one).
KILL_FLIP_LW = 2e-5

HEADLINE = dict(
    max_depth=128, tile_pixels=256, max_candidates=2048, segment=256,
    cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
    coarse_factor=8, super_group=4,
    budget_classes=((0.35, 128), (0.3, 192), (0.2, 288), (0.1, 384), (0.05, 512)),
    kernel_compact=True, cluster_sort=True,
)
N_PRIMS, WIDTH, SPP = 262144, 512, 2
# bench.py's train step (bench.py:1060-1071): one budget, no cluster sort
TRAIN = dict(
    max_depth=128, tile_pixels=256, max_candidates=2048, segment=256,
    cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
    coarse_factor=8, super_group=4, kernel_compact=True, refine_fraction=0.0,
)

# The backward kernel against its plain version. Its adjoints are
# ill-conditioned in f32 whatever computes them (g_u and the t* parts of
# the M rows are exactly 0 at the closest approach, so in f32 they are
# rounding noise; g_alpha divides by 1 - alpha), and it sums each column in
# another order than torch. So the plain version also runs in f64 as a
# yardstick, and every element of gpf is held to it:
# - per tile and row, the kernel's deviation from f64 is at most
#   GRAD_BAND times the plain f32 version's largest deviation in that tile
#   row, plus GRAD_FLOOR of the tile row's largest f64 value;
# - per row, over the elements that carry gradient, the kernel's median
#   deviation is at most GRAD_MEDIAN times the plain version's (plus
#   GRAD_FLOOR of the row's median |g|): a kernel that is a little off in
#   many columns, as one that drops some rays' contributions, fails here.
# gsh (bf16) is compared with the plain version's: each element within one
# bf16 ulp of its own value plus GSH_FLOOR of its tile row's largest (for
# sums that cancel), and at most GSH_DIFF_SHARE of the nonzero elements
# rounded differently at all (taking the bf16 basis for the f32 one moves
# most of them by an ulp). The v1 / v2 backwards hold every row, their f32
# gsh included, to the band and median checks, against :func:`yard12`.
GRAD_BAND = 4.0
GRAD_MEDIAN = 2.0
GRAD_FLOOR = 1e-6
GSH_FLOOR = 1e-5
GSH_DIFF_SHARE = 0.01

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# f32 operations per (ray, surviving column) pair: the pair math every
# pair runs (a 11, b 5, t* 1, p 6, q 14, clamp 1, hit test 2); per hit the
# forward adds alpha 3, the cap 1, w 2, emission 6k + 9 and log1p 2, and
# the backward adds alpha 3, emission 6k + 3, g_w and w 7, the carries 4,
# g_alpha, g_raw and g_q 9, the p, t*, a, b adjoints 31, the 13 rows 28,
# SH 3 + 3k, the sum over rays 13 + 3k and log1p 2
OPS_PAIR = 40
# the order band: per hit its entry key (a subtraction, a max, a divide, a
# square root and a subtraction, and the window's bookkeeping: 6), per pair
# of hits within the band one comparison and two sums (corr of both), and
# the backward again for the transposed band
OPS_BAND_KEY, OPS_BAND_PAIR = 6, 3


# The free-flight walk's bound counts f32 operations per interval the
# selection scans (its finite and open tests and its rank) and per erf term:
# CUDA's erff counted as 20 operations (a rational polynomial and a branch),
# plus 8 for its argument, the clamp, the difference, the product, the max
# and the sum. A walked window scans its row up to the (k+1)-th open
# interval (or the first padding entry) and takes 2 erf terms per selected
# interval; the window where a ray is found adds bisect_iters + 1
# (+ 1 + solver_iters with the solver) terms per selected interval.
OPS_SELECT = 3
OPS_ERFF = 20
OPS_ERF_TERM = OPS_ERFF + 8
# The walk kernel against its plain version: rays whose found / resolved /
# bdead / capres differ, plus rays found by both whose t_samp differs by
# more than WALK_ATOL + WALK_RTOL |t| (the tolerance of
# tests/test_ffwalk.py:63), may be at most WALK_DIFF_SHARE of the active
# rays (erff against torch.erf and another summation order move a window's
# depth by a few ulps, which decides a ray only at a rounding boundary).
WALK_ATOL, WALK_RTOL, WALK_DIFF_SHARE = 5e-3, 1e-3, 1e-3
# the path tracer's cell: the plume, and render_volume.py's film
PRB_PRIMS, PRB_WIDTH = 4096, 512


# The v1 / v2 cells (backend="pallas" / "pallas2"): the headline frame's
# scene, film and culls with the knobs those backends read (bench.py:813-831;
# prim_resort on by default). The fused-only knobs are left out: v1 and v2
# ignore them, as in JAX.
V12 = dict(
    max_depth=128, tile_pixels=256, max_candidates=2048, segment=256,
    cluster_size=16, coarse_group=4, coarse_factor=8, super_group=4,
)
# tiles per call of a plain version run in f64 (memory)
TILE_CHUNK = 128

# the profiler's DMA-floor probe at the profiler's kernel-stage tile blocks
# (tools/profile_rf.py at its defaults: 1024 tiles of 256 rays, 2048
# columns, 12 bf16 SH rows, segment 256)
CLONE = dict(T=1024, R=256, S=2048, rows=12, seg=256)
# the profiler's stages run in phase 17: its defaults and the rest
PROFILER_STAGES = ("full,nokernel,cull,gather,kernel,in_cull,in_pack,in_gather_pf,"
                   "in_gather,in_cull_nosel,cull_coarse,clone,segstats,"
                   "abl_nodepth,abl_noemis,abl_notrans,abl_nocum,abl_noop,abl_noop2,"
                   "abl_static,abl_fori")
# bench.py's order-band quality points (bench.py:956-980; BENCH_BAND_POINTS
# "16:4096,16:8192"): one budget, compaction, cluster sort, band 16
BAND_POINTS = (4096, 8192)
# the band of phase 6's synthetic checks: band_classes' and the CPU tests'
BAND_SYNTH = 8
BAND = dict(
    max_depth=128, tile_pixels=256, segment=256, cluster_size=16, backend="fused",
    early_exit=True, coarse_group=4, coarse_factor=8, super_group=4, refine_fraction=0.0,
    refine_factor=4, kernel_compact=True, cluster_sort=True, order_band=16,
)
# f32 operations per (ray, column) pair that a v1 / v2 kernel walks: the
# coefficients (v1: three 10-term dots, 57; v2: a 11, b 5), then q 3, clamp
# 1, disc 2, t_near 5 and the hit test 2
OPS_PAIR12 = {"pallas": 70, "pallas2": 29}


def ops_hit12_bwd(backend, k):
    """f32 operations of the backward per hit under the cap: the forward's
    (17 + 6k), the adjoints of w, the carries, alpha, q, a and b (32), the
    feature rows (v1: 10 rows of 5; v2: 9 rows of 1), the SH adjoints (3k)
    and one add per adjoint row into the sum over the tile's rays."""
    grad, cols = (50, 11) if backend == "pallas" else (9, 11)
    return 17 + 6 * k + 32 + grad + 3 * k + cols + 3 * k


def ops_hit12_zero_bwd(k):
    """f32 operations of the backward per hit under the cap with alpha = 0
    (a column of opacity 0, where the forward's work ends at the pair
    test): the emission and g_w (6k + 11), exp(lw), g_logt, g_alpha, g_raw
    and g_opac (9) and one add into the opacity row."""
    return 6 * k + 21


def ops_hit_fwd(k):
    return 17 + 6 * k


def ops_hit_bwd(k):
    return 103 + 12 * k


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """Device times of fn() in ms, sorted, over reps runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events)."""
    return float(np.median(cuda_times(fn, reps, warmup)))


def launch_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one short launch fn() in ms: a ~1 ms
    torch.cuda._sleep keeps the queue busy while the host prepares the
    launch, so the events time the kernel from its start on the device and
    not the wrapper's host work before it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_device_ms(fn, name: str):
    """Device ms of the kernels whose name holds ``name`` in one call of
    fn(), from torch.profiler's device-side rows; a trace that holds none
    of them is taken again, three times at most (None if none did)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3
    return None


def compare(got, want, n_rays: int) -> dict:
    """Max abs / rel difference and the rays outside the tolerance."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > ATOL + RTOL * want.abs()
    bad_rays = int(bad.reshape(n_rays, -1).any(dim=1).sum())
    return {
        "max_abs": float(diff.max()),
        "max_rel": float((diff / want.abs().clamp(min=1e-6)).max()),
        "rays_outside_tol": bad_rays,
        "max_abs_outside_tol": float(diff[bad].max()) if bad_rays else 0.0,
        "ok": bad_rays <= KILL_FLIP_SHARE * n_rays
        and (not bad_rays or float(diff[bad].max()) <= KILL_FLIP_ATOL),
    }


def device_profile(fn, out_dir: str, name: str, n: int = 2, stages: dict = None):
    """Device busy ms per call of fn(i) over n calls (torch.profiler's
    device-side rows: kernels and copies; the CPU-op rows repeat them),
    with the table written to out_dir/name. ``stages`` maps a module to
    names of its functions that are wrapped in torch.profiler ranges of the
    same name while profiling; then the device ms per call spent inside
    each range (ranges nest) is returned beside the busy ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label, fn_):
        def wrapper(*a, **k):
            with record_function(label):
                return fn_(*a, **k)
        return wrapper

    saved = [(mod, n_, getattr(mod, n_)) for mod, names in (stages or {}).items()
             for n_ in names]
    os.makedirs(out_dir, exist_ok=True)
    try:
        for mod, n_, fn_ in saved:
            setattr(mod, n_, ranged(n_, fn_))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
    finally:
        for mod, n_, fn_ in saved:
            setattr(mod, n_, fn_)
    events = prof.key_averages()
    labels = {n_ for _, n_, _ in saved}
    # the ranges also appear on the device as annotation spans, which
    # cover idle time: they are neither busy time nor a stage's time
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in labels
    )
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    if not stages:
        return busy_us / 1e3 / n
    # a range's host-side event sums the kernels launched inside it
    split = dict.fromkeys(sorted(labels), 0.0)
    for e in prof.events():
        if e.name in labels and e.device_type == torch.autograd.DeviceType.CPU:
            split[e.name] += e.device_time_total / 1e3 / n
    return busy_us / 1e3 / n, split


@torch.no_grad()
def work(composite3, d8, pf, sh3, n_seg_t, seg, extent2, max_depth, sh_k, compact,
         order_band=0, walked=None):
    """What one compositor call on these inputs must do: live columns,
    (ray, stream column) pairs, hits under the cap, hit pairs within the
    order band, and the least time of the forward and the backward on this
    card (ms, and what bounds it). Input bytes count the live segments'
    columns once; outputs are written whole. ``walked`` [T] (the forward
    under early exit, without compaction): each tile's segments past it
    are not read and count for nothing."""
    t, _, r = d8.shape
    s = pf.shape[2]
    lane = torch.arange(s, device=d8.device)
    n_live = torch.clamp(n_seg_t.long(), 0, s // seg)
    if walked is not None:
        n_live = torch.minimum(n_live, walked.long().to(d8.device))
    live = lane[None, :] // seg < n_live[:, None]
    hits = band_pairs = stream_cols = 0
    for t0 in range(0, t, TILE_CHUNK):  # memory: [tiles, R, seg] temporaries
        c = slice(t0, t0 + TILE_CHUNK)
        pf_s, _, nseg, _, inside = composite3._stream(d8[c], pf[c], sh3[c], n_live[c], seg,
                                                      compact)
        stream_cols += int(inside.sum()) if compact else int(live[c].sum())
        d3, f6, _, _ = composite3._ray_terms(d8[c], sh_k, sh3.dtype)
        count = torch.zeros((pf_s.shape[0], r, 1), device=d8.device)
        for si in range(int(nseg.max()) if nseg.numel() else 0):
            pr = composite3._segment_pairs(
                pf_s[:, :, si * seg:(si + 1) * seg], d3, f6, extent2 * 0.5,
                (si < nseg)[:, None, None],
            )
            depth_ok, count = composite3._capped(pr[7], count, max_depth)
            hm = pr[8] & depth_ok
            hits += int(hm.sum())
            for s_ in range(1, min(order_band, seg - 1) + 1):
                band_pairs += int((hm[..., :-s_] & hm[..., s_:]).sum())
    pairs = stream_cols * r
    n_live = int(live.sum())
    rays_in = t * 8 * r * 4 + t * 4
    cols_in = n_live * (16 * 4 + 3 * sh_k * 2)
    fwd_bytes = rays_in + cols_in + t * r * 4 * 4
    bwd_bytes = rays_in + cols_in + t * r * 4 * 4 + t * s * (16 * 4 + 3 * sh_k * 2)
    band_fwd = hits * OPS_BAND_KEY + band_pairs * OPS_BAND_PAIR if order_band else 0
    band_bwd = hits * OPS_BAND_KEY + band_pairs * 2 * OPS_BAND_PAIR if order_band else 0
    out = dict(live_columns=n_live, pairs=pairs, hits=hits, band_hit_pairs=band_pairs)
    for name, nbytes, ops in (
        ("fwd", fwd_bytes, pairs * OPS_PAIR + hits * ops_hit_fwd(sh_k) + band_fwd),
        ("bwd", bwd_bytes, pairs * OPS_PAIR + hits * ops_hit_bwd(sh_k) + band_bwd),
    ):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        out[f"{name}_bound_ms"] = max(t_bytes, t_ops)
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nbytes, ops
    return out


def fwd_work(composite3, a) -> dict:
    """:func:`work` of one recorded ``composite3._launch`` argument tuple
    ``a``; under early exit without compaction on the segments its plain
    version walks (the TPU kernel's semantics)."""
    walked = None
    if a[11] and not a[9]:
        walked = torch.cat([
            composite3._forward3_reference(a[0][c], a[1][c], a[2][c], a[3][c], *a[4:])[2]
            for c in (slice(t0, t0 + TILE_CHUNK) for t0 in range(0, a[0].shape[0], TILE_CHUNK))
        ])
    return work(composite3, *a[:4], a[4], a[5], a[6], a[8], a[9], a[10], walked=walked)


def bwd_work(composite3, a) -> dict:
    """:func:`work` of one recorded ``composite3._launch_bwd`` argument
    tuple ``a``."""
    return work(composite3, *a[:4], a[6], a[7], a[8], a[10], a[11], a[12])


def bf16_ulp(x):
    """One bf16 ulp of each element of |x| (0 where x is 0)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8), 0.0)


def band_check(gk, gp, gy, flips=None) -> dict:
    """The band and median checks of :func:`compare_grads` on [T, rows, S]
    arrays: the kernel's ``gk`` and the plain version's ``gp`` against the
    f64 yardstick ``gy``. ``flips`` (:func:`kill_flips`) excuses elements
    outside the band in the columns its near rays touch (counted and
    returned), if the near rays of the tiles that needed it (the flipped
    rays) are at most KILL_FLIP_SHARE of the rays (at least one); an
    element outside the band in any other column still fails. Returns the
    elements outside the band (and the first few), per-row medians, and
    whether every check passed."""
    gy = gy.double()
    e_k, e_p = (gk.double() - gy).abs(), (gp.double() - gy).abs()
    tile_row = gy.abs().amax(dim=2, keepdim=True)
    band = GRAD_BAND * e_p.amax(dim=2, keepdim=True) + GRAD_FLOOR * tile_row
    outside = e_k > band
    flip = {"near_rays": 0, "flipped_rays": 0, "excused_columns": 0, "elements_excused": 0,
            "flips_ok": True}
    if flips is not None:
        exc = flips["excused"].to(outside.device)[:, None, :]
        # the near rays of the tiles where an element needed the excuse
        used = (outside & exc).flatten(1).any(dim=1).cpu()
        flipped = int(flips["near_per_tile"][used].sum())
        flip = {"near_rays": int(flips["near_per_tile"].sum()), "flipped_rays": flipped,
                "excused_columns": int(flips["excused"].sum()),
                "elements_excused": int((outside & exc).sum()),
                "flips_ok": flipped <= max(1.0, KILL_FLIP_SHARE * flips["rays"])}
        outside = outside & ~exc
    carry = gy != 0
    rows, failed = [], []
    for i in range(gy.shape[1]):
        m = carry[:, i]
        if not bool(m.any()):
            rows.append(None)
            continue
        med = lambda x: float(x[:, i][m].median())  # noqa: E731
        g_med, k_med, p_med = med(gy.abs()), med(e_k), med(e_p)
        ok = k_med <= GRAD_MEDIAN * p_med + GRAD_FLOOR * g_med
        if not ok:
            failed.append(i)
        rows.append({
            "median_g": g_med, "median_band": med(band.expand_as(gy)),
            "median_dev": k_med, "median_dev_plain": p_med,
            "outside": int(outside[:, i].sum()), "median_ok": ok,
        })
    n_out = int(outside.sum())
    # the first elements outside: (tile, row, column, kernel, plain, f64, band)
    examples = [[int(i) for i in ix] + [float(x[tuple(ix)]) for x in (gk, gp, gy)]
                + [float(band[ix[0], ix[1], 0])] for ix in torch.nonzero(outside)[:4].tolist()]
    return {"rows": rows, "elements_outside_band": n_out, "outside_examples": examples,
            "rows_median_failed": failed,
            **flip, "ok": n_out == 0 and not failed and flip["flips_ok"]}


def compare_grads(got, plain, yard, flips=None) -> dict:
    """The backward kernel's (gpf, gsh) against the plain version's, with
    the plain version's gpf in f64 as the yardstick (see GRAD_BAND) and
    ``flips`` as in :func:`band_check` (which also excuses those columns of
    gsh). Per row of gpf it reports the median band beside the median |g|,
    so a reader can see the check is tight enough to fail a wrong kernel."""
    gk, sk = got
    gp, sp = plain
    band = band_check(gk, gp, yard, flips)
    sk, sp = sk.float(), sp.float()
    sdiff = (sk - sp).abs()
    s_band = bf16_ulp(torch.maximum(sk.abs(), sp.abs())) + GSH_FLOOR * sp.abs().amax(
        dim=2, keepdim=True
    )
    s_bad = sdiff > s_band
    if flips is not None:
        s_bad &= ~flips["excused"].to(s_bad.device)[:, None, :]
    s_out = int(s_bad.sum())
    s_nz = (sk != 0) | (sp != 0)
    s_share = float((sdiff[s_nz] > 0).float().mean()) if bool(s_nz.any()) else 0.0
    tile_row_p = gp.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    tile_row_s = sp.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    return {
        "gpf": {
            "max_abs": float((gk - gp).abs().max()),
            "max_rel_tile_row": float(((gk - gp).abs() / tile_row_p).max()),
            "elements_outside_band": band["elements_outside_band"], "rows": band["rows"],
        },
        "gsh": {
            "max_abs": float(sdiff.max()),
            "max_rel_tile_row": float((sdiff / tile_row_s).max()),
            "elements_outside_ulp": s_out,
            "share_differing": s_share,
        },
        **{k: band[k] for k in ("near_rays", "flipped_rays", "excused_columns",
                                "elements_excused")},
        "ok": band["ok"] and s_out == 0 and s_share <= GSH_DIFF_SHARE,
    }


def v12_rows(grads):
    """The v1 / v2 backward's (gpf [T, S, 16], gcol [T, k, S],
    gsh [T, S, 48]) as one [T, 16 + k + 48, S] array."""
    gpf, gcol, gsh = grads
    return torch.cat([gpf.transpose(1, 2), gcol, gsh.transpose(1, 2)], dim=1)


def compare_grads12(got, plain, yard, flips=None) -> dict:
    """The v1 / v2 backward kernel's (gpf, gcol, gsh) against the plain
    version's, with the plain version's f64 run (:func:`yard12`) as the
    yardstick: every row
    of gpf, of gcol (opacity; v2 also c0) and of gsh (f32 here) is held per
    tile and row to the band and per row to the median check of
    :func:`compare_grads` (GRAD_BAND, GRAD_MEDIAN, GRAD_FLOOR), with
    ``flips`` as in :func:`band_check`."""
    gk, gp, gy = v12_rows(got), v12_rows(plain), v12_rows(yard)
    out = band_check(gk, gp, gy, flips)
    # how tight the median check is: the largest row median deviation of
    # the kernel and of the plain version, each over the row's median |g|
    live = [q for q in out["rows"] if q and q["median_g"] > 0]
    for key, dev in (("max_row_median_dev_rel", "median_dev"),
                     ("max_row_median_dev_plain_rel", "median_dev_plain")):
        out[key] = max((q[dev] / q["median_g"] for q in live), default=0.0)
    out["max_abs"] = float((gk - gp).abs().max())
    out["max_rel_tile_row"] = float(
        ((gk - gp).abs() / gp.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)).max()
    )
    return out


@torch.no_grad()
def kill_flips(walk, t, r, s, log_kill) -> dict:
    """The rays a KILL_FLIP may move (near rays: a hit within KILL_FLIP_LW
    of log(beta_kill)) and the tile columns whose adjoints they may move.
    ``walk(tiles)`` (called on TILE_CHUNK tiles at a time, then on the
    near rays' tiles) runs the plain version's pair math on the tiles of
    the index tensor ``tiles`` and returns
    (segments, to_slots): ``segments`` yields per stream segment (first
    lane, lw, cand, under), [T', R, C] each, with ``cand`` the hits under
    the cap with alpha > 0 and ``under`` every hit under the cap;
    ``to_slots`` maps a [T', stream lanes] mask to the tiles' [T', S]
    columns. A flipped ray's hits up to its last near hit are excused: g_lw
    changes at that hit, and g_logt, a suffix sum, at every earlier one.
    Returns {excused [T, S] bool, near_per_tile [T], rays}."""
    last = []
    for t0 in range(0, t, TILE_CHUNK):
        chunk = torch.arange(t0, min(t0 + TILE_CHUNK, t))
        segments, _ = walk(chunk)
        lim = None
        for lane0, lw, cand, _ in segments:
            near = cand & ((lw - log_kill).abs() <= KILL_FLIP_LW)
            lanes = torch.arange(lane0, lane0 + near.shape[-1], device=near.device)
            pos = torch.where(near, lanes, -1).amax(dim=-1)
            lim = pos if lim is None else torch.maximum(lim, pos)
        last.append(lim.cpu() if lim is not None else torch.full((len(chunk), r), -1))
    last = torch.cat(last)  # [T, R] stream lane of each ray's last near hit, or -1
    excused = torch.zeros((t, s), dtype=torch.bool)
    tiles = torch.nonzero((last >= 0).any(dim=1))[:, 0]
    if tiles.numel():
        segments, to_slots = walk(tiles)
        lim = last[tiles]
        cols = []
        for lane0, _, _, under in segments:
            lanes = torch.arange(lane0, lane0 + under.shape[-1], device=under.device)
            cols.append((under & (lanes <= lim.to(under.device)[..., None])).any(dim=1))
        stream = torch.cat(cols, dim=1)
        stream = torch.cat([stream, stream.new_zeros((stream.shape[0], s - stream.shape[1]))],
                           dim=1)
        excused[tiles] = to_slots(stream).cpu()
    return {"excused": excused, "near_per_tile": (last >= 0).sum(dim=1), "rays": t * r}


def walk12(api, tensors, kw, tiles):
    """:func:`kill_flips`'s ``walk`` for a v1 / v2 compositor: the plain
    version's f32 pair math and carries on ``tiles``."""
    from volprim_tpu_torch.kernels import composite

    tensors = [x[tiles.to(x.device)] for x in tensors]
    coeffs_of, opac_of = api.walk_fns(tensors, kw)
    t, r = tensors[0].shape[:2]
    seg = kw["seg"]

    def segments():
        log_beta = torch.zeros((t, r, 1), device=tensors[0].device)
        count = torch.zeros_like(log_beta)
        for si in range(tensors[-1].shape[1] // seg):
            st, count = composite._segment_state(si, coeffs_of, opac_of, kw["extent2"],
                                                 kw["max_depth"], log_beta, count)
            under = st["hit"] & st["depth_ok"]
            yield si * seg, st["lw"], under & (st["alpha"] > 0.0), under
            log_beta = log_beta + st["cs_incl"][..., -1:]

    return segments(), lambda m: m


def walk3(composite3, d8, pf, sh3, n_seg_t, kw, tiles):
    """:func:`kill_flips`'s ``walk`` for the v3 compositor: its plain
    version's stream (compacted or not), pair math, carries and order band
    on ``tiles``, in f32."""
    dv = tiles.to(d8.device)
    d8, pf, sh3, n_seg_t = d8[dv], pf[dv], sh3[dv], n_seg_t[dv]
    seg, band = kw["seg"], kw.get("order_band", 0)
    pf_s, _, nseg, order, inside = composite3._stream(d8, pf, sh3, n_seg_t, seg,
                                                      kw["compact"])
    d3, f6, _, _ = composite3._ray_terms(d8, kw["sh_k"], sh3.dtype)
    e2h = kw["extent2"] * 0.5

    def segments():
        log_beta = torch.zeros((d8.shape[0], d8.shape[2], 1), device=d8.device)
        count = torch.zeros_like(log_beta)
        for si in range(int(nseg.max()) if nseg.numel() else 0):
            cols = pf_s[:, :, si * seg:(si + 1) * seg]
            pairs = composite3._segment_pairs(cols, d3, f6, e2h, (si < nseg)[:, None, None])
            depth_ok, count = composite3._capped(pairs[7], count, kw["max_depth"])
            alpha = torch.where(depth_ok, pairs[7], 0.0)
            logt = torch.log1p(-alpha)
            cs_incl = torch.cumsum(logt, dim=-1)
            cs_excl = cs_incl - logt
            if band:
                tkey = composite3._entry_keys(cols, d3, f6, e2h)
                cs_excl = cs_excl + composite3._band_corr(tkey, logt, band)
            under = depth_ok & pairs[8]
            yield si * seg, log_beta + cs_excl, under & (alpha > 0.0), under
            log_beta = log_beta + cs_incl[..., -1:]

    def to_slots(m):
        if order is None:
            return m
        m = m.to(order.device) & inside
        return torch.zeros_like(m).scatter_(1, order, m)

    return segments(), to_slots


def ptxas_table(log: str) -> list:
    """Registers, stack and spill bytes per compiled kernel from nvcc's
    ``-Xptxas -v`` log, with the template arguments of the compositors'
    instantiations (fwd3_kernel: k, banded, threads, ablation; bwd3_kernel:
    k, banded, threads; banded is 0 or 1; fwd12_kernel and bwd12_kernel,
    the v1 / v2 forward and backward: version, k, threads) and of the walk
    (ffwalk_kernel: slots per lane, 0 for shared memory)."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            cur = m.group(1)
            if not rows or rows[-1]["function"] != cur:
                inst = re.search(
                    r"((?:fwd|bwd)(?:3|12)_kernel|ffwalk_kernel)I((?:L[ib](?:n?\d+)E)+)E", cur)
                rows.append(dict(function=cur, kernel=inst.group(1) if inst else None,
                                 args=[int(x.replace("n", "-")) for x in
                                       re.findall(r"L[ib](n?\d+)E", inst.group(2))] if inst else None))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and rows:
            rows[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return [r for r in rows if "registers" in r]


def spill_gated(source, row) -> bool:
    """Whether a ptxas_table row of ``csrc/<source>.cu`` is one that must
    not spill: the path's k = 4 compositor instantiations at 256 and 512
    threads (v3 unbanded, forward and backward; the v1 / v2 backwards; the
    v2 forward and v1's, whose one build per block size takes every k), and
    the walk's at k <= 32 (one slot per lane)."""
    args = row["args"]
    if row["kernel"] == "ffwalk_kernel":
        return source == "ffwalk" and args == [1]
    # threads third in every compositor's arguments
    if not args or args[2] not in (256, 512):
        return False
    if row["kernel"] in ("fwd3_kernel", "bwd3_kernel"):
        return source in ("composite3_fwd", "composite3_bwd") and args[:2] == [4, 0]
    if row["kernel"] == "fwd12_kernel":
        return args[0] == 1 or args[1] == 4
    return row["kernel"] == "bwd12_kernel" and args[1] == 4


@torch.no_grad()
def check_bwd(composite3, args, kw, compact, reps=10):
    """The backward kernel on ``args`` = (d8, pf, sh3, n_seg_t, g_l,
    g_beta) against its plain version (f32, and f64 as the yardstick; both
    walk the kernel's stream), with CUDA-event times of both. A second
    launch on the same inputs must give bit-identical gpf and gsh (the
    kernel sums in a fixed order, with no atomics): else it fails. The
    comparison excuses the KILL_FLIP rays' columns (:func:`kill_flips`)."""
    d8, pf, sh3, n_seg_t, g_l, g_beta = args
    kw = dict(kw, compact=compact)
    got = composite3.composite_tiles3_bwd(*args, **kw)
    again = composite3.composite_tiles3_bwd(*args, **kw)
    if not (torch.equal(got[0], again[0])
            and torch.equal(got[1].view(torch.int16), again[1].view(torch.int16))):
        fail(f"two launches of the backward kernel (order_band {kw.get('order_band', 0)}, "
             f"compact {compact}) on the same inputs gave gpf / gsh that are not bit-identical")
    del again
    plain = composite3.composite_tiles3_bwd_reference(*args, **kw)
    yard, _ = composite3.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, g_l, g_beta, **kw
    )
    flips = kill_flips(lambda tiles: walk3(composite3, d8, pf, sh3, n_seg_t, kw, tiles),
                       d8.shape[0], d8.shape[2], pf.shape[2],
                       composite3._log_kill(kw["beta_kill"]))
    torch.cuda.synchronize()
    cmp_ = compare_grads(got, plain, yard, flips)
    del yard
    ms = cuda_ms(lambda: composite3.composite_tiles3_bwd(*args, **kw), reps)
    plain_ms = cuda_ms(
        lambda: composite3.composite_tiles3_bwd_reference(*args, **kw), 3, warmup=1
    )
    return cmp_, ms, plain_ms


def walk_kwargs(kw) -> dict:
    """All of ffwalk._launch's keyword arguments, defaults filled in."""
    return {"bisect_iters": 22, "solver_iters": 4, "solver_disabled": False, **kw}


def walk_work(args, kw, work) -> dict:
    """Bytes and f32 operations one walk on ``args`` must do, and the least
    time of it on this card. ``work`` is walk_reference's count of what
    these inputs make the walk do. Bytes: entry and exit of the longest
    prefix of each row that a window scans, cp, alpha and beta of the
    intervals a window selects, and four [R] floats plus the active byte
    read once; four flag bytes and t_samp written once. ``design_bytes``
    is what csrc/ffwalk.cu reads and writes instead: entry and exit in
    whole 128-interval groups up to that prefix (group 0 of every row)."""
    r = args[0].shape[0]
    kw = walk_kwargs(kw)
    nbytes = (work.get("scanned_max", 0) * 2 * 4 + work.get("selected_union", 0) * 3 * 4
              + r * (4 * 4 + 1) + r * (4 + 4))
    per_found = kw["bisect_iters"] + 1 + (0 if kw["solver_disabled"] else 1 + kw["solver_iters"])
    ops = (work.get("scanned", 0) * OPS_SELECT
           + (2 * work.get("selected", 0) + per_found * work.get("selected_found", 0))
           * OPS_ERF_TERM)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    design = (work.get("group_entries", 0) * 2 * 4 + work.get("selected_union", 0) * 3 * 4
              + r * (4 * 4 + 1) + r * (4 + 4))
    return dict(bytes=nbytes, design_bytes=design, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", work=work)


def compare_walk(got, want, n_active: int) -> dict:
    """The wrapper ffwalk.walk's (found, resolved, bdead, capres, t_samp)
    against walk_reference's on the same inputs (see WALK_DIFF_SHARE), the
    reference's t_samp taken to +inf where not found, as the wrapper takes
    it: a ray also differs where one t_samp is inf and the other is not."""
    want_t = torch.where(want[0], want[4], torch.inf)
    differ = torch.isinf(got[4]) != torch.isinf(want_t)
    for g, w in zip(got[:4], want[:4]):
        differ |= g != w
    both = got[0] & want[0]
    dt = (got[4] - want_t).abs()[both]
    outside = dt > WALK_ATOL + WALK_RTOL * want_t[both].abs()
    n_diff, n_out = int(differ.sum()), int(outside.sum())
    return dict(
        active_rays=n_active, found=int(got[0].sum()), decisions_differ=n_diff,
        t_outside_tol=n_out, max_abs_dt=float(dt.max()) if dt.numel() else 0.0,
        max_abs_dt_outside=float(dt[outside].max()) if n_out else 0.0,
        ok=n_diff + n_out <= WALK_DIFF_SHARE * n_active,
    )


class V12Api:
    """The v1 or v2 compositor's wrappers, launchers, plain versions and
    launch counters, and how its recorded launch arguments split into
    tensors and keywords."""

    def __init__(self, backend):
        from volprim_tpu_torch.kernels import composite, composite2, composite_vjp

        self.backend = backend
        if backend == "pallas":
            self.fwd_mod, self.bwd_mod = composite, composite_vjp
            self.fwd, self.fwd_ref = composite.composite_tiles, composite.composite_tiles_reference
            self.bwd = composite_vjp.composite_tiles_bwd
            self.bwd_ref = composite_vjp.composite_tiles_bwd_reference
            self.fwd_counter, self.n_in = composite.composite_tiles, 7
            self.keys = ("seg", "extent2", "max_depth", "beta_kill")
            self.bwd_counter = composite_vjp.composite_tiles_bwd
        else:
            self.fwd_mod = self.bwd_mod = composite2
            self.fwd, self.fwd_ref = composite2.composite_tiles2_fwd, composite2.composite_tiles2_reference
            self.bwd = composite2.composite_tiles2_bwd
            self.bwd_ref = composite2.composite_tiles2_bwd_reference
            self.fwd_counter, self.n_in = composite2.composite_tiles2, 4
            self.keys = ("seg", "extent2", "max_depth", "beta_kill", "sh_k")
            self.bwd_counter = composite2.composite_tiles2_bwd

    def split(self, args, n_extra=0):
        """Recorded launch arguments -> (tensors, keywords); the backward
        has ``n_extra`` = 2 more tensors (the cotangents)."""
        n = self.n_in + n_extra
        return list(args[:n]), dict(zip(self.keys, args[n:]))

    def walk_fns(self, tensors, kw):
        """(coeffs_of, opac_of) of the plain versions on these inputs."""
        from volprim_tpu_torch.kernels import composite, composite2

        if self.backend == "pallas":
            fa, fb, fc, _, pf, opac, _ = tensors
            seg = kw["seg"]
            return (composite.v1_coeffs(fa, fb, fc, pf, seg),
                    lambda si: opac[:, :, si * seg:(si + 1) * seg])
        return composite2._walk_args(*tensors, kw["seg"], kw["sh_k"])[:2]

    def sh_k(self, tensors, kw):
        """SH coefficients per channel that the kernels evaluate: v2's sh_k;
        v1's basis columns that are nonzero somewhere (the kernel skips a
        column that is zero across a warp; rf_tiled pads the basis to 16)."""
        if self.backend == "pallas":
            return int((tensors[3] != 0).any(dim=1).any(dim=0).sum())
        return kw["sh_k"]


@torch.no_grad()
def work12(api, tensors, kw) -> dict:
    """What one v1 / v2 compositor call on these inputs must do, and the
    least time of its forward and backward on this card. Pairs: every
    (ray, column) pair up to the ray's cap (the pair that takes its count
    past max_depth included); ``pairs_fwd`` only those on columns of
    opacity > 0, the forward's: a column of opacity <= 0 gives alpha <= 0
    at every hit and takes no pair math in the forward. Hits: pairs that
    hit under the cap, counted apart by alpha > 0 (``hits_alpha``) and
    alpha = 0 (``hits_zero``: a column of opacity 0), which the backward
    charges only the emission's g_w and the opacity row
    (:func:`ops_hit12_zero_bwd`). Bytes: the ray inputs, the columns of the
    segments that some ray of the tile enters under its cap, and the
    outputs, each once; of the inputs only the entries the kernels read:
    v1's 10 live features of fa, fb, fc and pf and its live basis columns,
    v2's direction and 9 live features, and 3 k SH floats of a column
    (k = api.sh_k); the forward reads only the opacity of a column of
    opacity <= 0 (``live_columns_opaque`` counts the others)."""
    from volprim_tpu_torch.kernels import composite

    coeffs_of, opac_of = api.walk_fns(tensors, kw)
    t, r = tensors[0].shape[:2]
    s = tensors[-1].shape[1]
    seg, md = kw["seg"], kw["max_depth"]
    count = torch.zeros((t, r, 1), device=tensors[0].device)
    pairs = pairs_fwd = hits_alpha = hits_zero = live_cols = live_opaque = 0
    for si in range(s // seg):
        entered = (count <= md).any(dim=1)  # [T, 1]
        live_cols += int(entered.sum()) * seg
        a, b, c = coeffs_of(si)
        opac = opac_of(si)
        opaque = opac > 0.0  # [T, 1, C]
        live_opaque += int((entered[:, :, None] & opaque).sum())
        _, hit, _, _, alpha0 = composite.pair_terms(a, b, c, opac, kw["extent2"])
        pos = (alpha0 > 0.0).to(count.dtype)
        cum = count + torch.cumsum(pos, dim=-1)
        walked = cum - pos <= md
        pairs += int(walked.sum())
        pairs_fwd += int((walked & opaque).sum())
        under = hit & (cum <= md)
        hits_alpha += int((under & (alpha0 > 0.0)).sum())
        hits_zero += int((under & ~(alpha0 > 0.0)).sum())
        count = cum[..., -1:]
        del a, b, c, hit, alpha0, pos, cum, under, walked
    k = api.sh_k(tensors, kw)
    v1 = api.backend == "pallas"
    ray_bytes = t * r * ((3 * 10 + k) if v1 else 3) * 4
    col_bytes = ((10 + 1) if v1 else (9 + 2)) * 4 + 3 * k * 4  # features, opac (c0), SH
    out_cols = 16 + (1 if v1 else 2) + 48
    out_bytes = t * r * 4 * 4
    fwd_bytes = ray_bytes + live_cols * 4 + live_opaque * (col_bytes - 4) + out_bytes
    bwd_bytes = (ray_bytes + live_cols * col_bytes + out_bytes + t * r * 4 * 4
                 + t * s * out_cols * 4)
    ops_pair = OPS_PAIR12[api.backend]
    out = dict(pairs=pairs, pairs_fwd=pairs_fwd, hits=hits_alpha + hits_zero,
               hits_alpha=hits_alpha, hits_zero=hits_zero, live_columns=live_cols,
               live_columns_opaque=live_opaque, sh_k=k)
    for name, nbytes, ops in (
        ("fwd", fwd_bytes, pairs_fwd * ops_pair + hits_alpha * ops_hit_fwd(k)),
        ("bwd", bwd_bytes, pairs * ops_pair + hits_alpha * ops_hit12_bwd(api.backend, k)
         + hits_zero * ops_hit12_zero_bwd(k)),
    ):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        out[f"{name}_bound_ms"] = max(t_bytes, t_ops)
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nbytes, ops
    return out


@torch.no_grad()
def check_fwd12(api, tensors, kw, reps=10) -> dict:
    """The forward wrapper (which launches the kernel) against its plain
    version on the same inputs, with CUDA-event times of both."""
    got = api.fwd(*tensors, **kw)
    want = api.fwd_ref(*tensors, **kw)
    torch.cuda.synchronize()
    nr = tensors[0].shape[0] * tensors[0].shape[1]
    row = dict(L=compare(got[0], want[0], nr), beta=compare(got[1], want[1], nr))
    del got, want
    row["ok"] = row["L"]["ok"] and row["beta"]["ok"]
    if reps:
        row["ms"] = cuda_ms(lambda: api.fwd(*tensors, **kw), reps)
        row["plain_ms"] = cuda_ms(lambda: api.fwd_ref(*tensors, **kw), 2, warmup=1)
    return row


@torch.no_grad()
def yard12(bwd_ref, tensors, cot, kw):
    """The f64 yardstick of a v1 / v2 backward: its plain version
    ``bwd_ref`` on ``tensors`` in f64, TILE_CHUNK tiles at a time, with a,
    b, c, q and the hit test formed in f32 (``pair_dtype``). q = c - b^2 / a
    cancels at small primitive scales, so an f64 q would take other hits
    and other alphas than both f32 versions and measure that instead of
    their compositing and adjoint arithmetic."""
    t = tensors[0].shape[0]
    parts = [
        bwd_ref(*(x[i:i + TILE_CHUNK].double() for x in tensors),
                *(c[i:i + TILE_CHUNK] for c in cot), pair_dtype=torch.float32, **kw)
        for i in range(0, t, TILE_CHUNK)
    ]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


@torch.no_grad()
def check_bwd12(api, tensors, cot, kw, reps=10) -> dict:
    """The backward wrapper against its plain version in f32, with
    :func:`yard12` as the yardstick (compare_grads12, KILL_FLIP columns
    excused by :func:`kill_flips`), and CUDA-event times of both. A second
    launch on the same inputs must give torch.equal gpf, gcol and gsh (the
    kernels sum in a fixed order, with no atomics): else it fails."""
    from volprim_tpu_torch.kernels import composite

    got = api.bwd(*tensors, *cot, **kw)
    again = api.bwd(*tensors, *cot, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"two launches of the {api.backend} backward (R = {tensors[0].shape[1]}, "
             f"max_depth {kw['max_depth']}) on the same inputs gave gpf / gcol / gsh that "
             "are not bit-identical")
    del again
    plain = api.bwd_ref(*tensors, *cot, **kw)
    yard = yard12(api.bwd_ref, tensors, cot, kw)
    t, r = tensors[0].shape[:2]
    flips = kill_flips(lambda tiles: walk12(api, tensors, kw, tiles), t, r,
                       tensors[-1].shape[1], composite._log_kill(kw["beta_kill"]))
    torch.cuda.synchronize()
    row = compare_grads12(got, plain, yard, flips)
    row["bit_identical"] = True
    del got, plain, yard
    if reps:
        row["ms"] = cuda_ms(lambda: api.bwd(*tensors, *cot, **kw), reps)
        row["plain_ms"] = cuda_ms(lambda: api.bwd_ref(*tensors, *cot, **kw), 2, warmup=1)
    return row


def synthetic12(backend, t, r, s, seed, dev, sh_k=4):
    """Synthetic tiles of the v1 / v2 compositors, made with numpy from
    ``seed``: (tensors, cotangents, keywords) of the backward. Unit
    directions in a narrow cone from an origin 3 units in front of
    primitives of scale 0.02-0.08 (each ray hits about a hundred of the
    2048, so the cap and beta_kill decide), each tile's columns in depth
    order; a third of the columns at opacity 0 (among the others, so that
    their hits lie under the cap) and the last 64 neutral padding rows (as
    rf_tiled pads); SH of degree 1 and normal cotangents."""
    from types import SimpleNamespace

    from volprim_tpu_torch.kernels import composite2
    from volprim_tpu_torch.ops import quadric, sh

    rng = np.random.default_rng(seed)
    origin = np.array([0.1, 0.2, -3.0], np.float32)
    d = rng.normal(0.0, 0.05, (t, r, 3)) + np.array([0.0, 0.0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    centers = rng.normal(0.0, 0.3, (t, s, 3)).astype(np.float32)
    order = np.argsort(centers[..., 2], axis=1)
    centers = np.take_along_axis(centers, order[..., None], 1).reshape(-1, 3)
    scales = rng.uniform(0.02, 0.08, (t * s, 3)).astype(np.float32)
    quats = rng.normal(size=(t * s, 4))
    quats = (quats / np.linalg.norm(quats, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.05, 0.6, (t, s)).astype(np.float32)
    opac[rng.uniform(size=(t, s)) < 1 / 3] = 0.0
    opac[:, s - 64:] = 0.0
    sh3 = np.zeros((t, s, 48), np.float32)
    for ch in range(3):
        sh3[..., ch * 16:ch * 16 + sh_k] = rng.normal(0.0, 0.4, (t, s, sh_k))
    g_l = rng.normal(size=(t, r, 3)).astype(np.float32)
    g_beta = rng.normal(size=(t, r)).astype(np.float32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    prims = SimpleNamespace(centers=to(centers), scales=to(scales), quats=to(quats))
    kw = dict(seg=256, extent2=9.0, max_depth=128, beta_kill=0.01)
    if backend == "pallas":
        o = to(np.broadcast_to(origin, (t * r, 3)))
        fa, fb, fc = (torch.cat([f, f.new_zeros((t * r, 6))], -1).reshape(t, r, 16)
                      for f in quadric.ray_features(o, to(d.reshape(-1, 3))))
        basis = sh.eval_basis(to(d.reshape(-1, 3)), sh.degree_from_coeffs(sh_k))
        basis = torch.cat([basis, basis.new_zeros((t * r, 16 - sh_k))], -1).reshape(t, r, 16)
        pf = torch.zeros((t * s, 16), device=dev)
        pf[:, :10] = quadric.prim_features(prims.centers, prims.scales, prims.quats).T
        pf = pf.reshape(t, s, 16)
        pf[:, s - 64:] = 0.0
        pf[:, s - 64:, :3] = 1.0
        tensors = [fa, fb, fc, basis.contiguous(), pf.contiguous(), to(opac[:, None, :]),
                   to(sh3)]
    else:
        o = to(origin)
        pf = composite2.camera_relative_features_from_prims(prims, o).reshape(t, s, 16)
        pf[:, s - 64:] = composite2.neutral_row(o)
        aux = torch.stack([to(opac), pf[..., 9]], dim=1)
        aux[:, 1, s - 64:] = float((o * o).sum())
        d8 = torch.cat([to(d), torch.zeros((t, r, 5), device=dev)], -1)
        tensors = [d8.contiguous(), pf.contiguous(), aux.contiguous(), to(sh3)]
        kw["sh_k"] = sh_k
    return tensors, [to(g_l), to(g_beta)], kw


def fwd12_cases(backend, dev):
    """The :func:`synthetic12` tile sets (16 tiles, S = 2048, seg 256) that
    the v1 / v2 forward is held to, as (label, tensors, keywords) at
    max_depth 128 and 8: every block size (R = 256, 512, 1024) at k = 4,
    then R = 256 at k = 1, 9 and 16, which set the staged SH width (3 k
    floats a column) and so the window, and the v2 instantiations over K;
    for v1 also a set at k = 16 whose tiles keep 16, 9, 4 and 1 live basis
    columns in turn, so that the blocks of one launch find different
    counts. Only hits with alpha > 0 count toward the cap, and the kernels
    skip the columns of opacity 0 that lie among the others: at max_depth
    8 a skipped column that counted would move the cap."""
    cases = [(r, 4, False) for r in (256, 512, 1024)] + [(256, k, False) for k in (1, 9, 16)]
    if backend == "pallas":
        cases.append((256, 16, True))
    for r, k, mixed in cases:
        tensors, _, kw = synthetic12(backend, 16, r, 2048, seed=r if k == 4 else r + k,
                                     dev=dev, sh_k=k)
        if mixed:
            for ti in range(tensors[3].shape[0]):
                tensors[3][ti, :, (16, 9, 4, 1)[ti % 4]:] = 0.0
        for md in (128, 8):
            yield f"R{r}_k{k}{'_mixed' if mixed else ''}_md{md}", tensors, dict(kw, max_depth=md)


def fwd12_synthetic(backend, name, dev, details) -> list:
    """The v1 / v2 forward on every set of :func:`fwd12_cases` against its
    plain version (check_fwd12)."""
    api = V12Api(backend)
    rows = []
    for label, tensors, kw in fwd12_cases(backend, dev):
        t, r = tensors[0].shape[:2]
        row = dict(case=label, T=t, R=r, S=tensors[-1].shape[1], max_depth=kw["max_depth"],
                   **check_fwd12(api, tensors, kw, reps=5))
        row.update(work12(api, tensors, kw))
        rows.append(row)
        phase(f"{name}_fwd_synthetic", **row)
        if not row["ok"]:
            fail(f"{name}: the forward kernel disagrees with its plain version on "
                 f"synthetic tiles {label}")
    details[f"{name}_fwd_synthetic"] = rows
    return rows


def bwd12_synthetic(backend, name, dev, details) -> list:
    """Every block size of the v1 / v2 backward (R = 256, 512 and 1024
    rays, S = 2048, seg 256, k = 4) on :func:`synthetic12` tiles against
    its plain version (check_bwd12: yard12, compare_grads12, two launches
    bit-identical)."""
    api = V12Api(backend)
    rows = []
    for r in (256, 512, 1024):
        tensors, cot, kw = synthetic12(backend, 16, r, 2048, seed=r, dev=dev)
        row = dict(T=16, R=r, S=2048, **check_bwd12(api, tensors, cot, kw, reps=5))
        row.update(work12(api, tensors, kw))
        row.pop("rows")
        rows.append(row)
        phase(f"{name}_bwd_synthetic", **row)
        if not row["ok"]:
            fail(f"{name}: the backward kernel disagrees with its plain version on synthetic "
                 f"tiles at R = {r}")
    details[f"{name}_bwd_synthetic"] = rows
    return rows


def record_launches(module, name, counter, fn):
    """Run fn() with module.name wrapped to record its argument tuples and
    the launch count of ``counter`` set to 0 just before and read just
    after: (fn's result, launches, recorded argument tuples)."""
    recorded, launch = [], getattr(module, name)

    def recording(*a):
        recorded.append(tuple(x.detach() if torch.is_tensor(x) else x for x in a))
        return launch(*a)

    setattr(module, name, recording)
    counter.launches = 0
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        launches = counter.launches
        setattr(module, name, launch)
    return out, launches, recorded


def psnr_db(a, b) -> float:
    return -10.0 * math.log10(max(float(torch.mean((a - b) ** 2)), 1e-12))


def v12_frame(backend, name, scene, camera, exact, sel, fused_img, details, out=None) -> dict:
    """Phase 12 / 14: the V12 frame through ``backend``; every forward
    launch's recorded inputs are replayed through the wrapper against the
    plain version, then every block size on synthetic tiles
    (:func:`fwd12_synthetic`). Returns the kernel's numbers for the kernels
    line."""
    from volprim_tpu_torch.models import rf_tiled

    t_phase = time.perf_counter()
    api = V12Api(backend)
    cfg = rf_tiled.RFTiledConfig(backend=backend, **V12)
    state = rf_tiled.build_state(scene, cfg)

    def frame(seed, spp=SPP, jitter=True):
        return rf_tiled.render_state(state, camera, cfg, None, spp=spp, seed=seed, jitter=jitter)

    # the counted run: counts set to 0 just before, read just after
    img, launches, recorded = record_launches(api.fwd_mod, "_launch", api.fwd_counter,
                                              lambda: frame(1))
    if launches != SPP or len(recorded) != SPP:
        fail(f"{name}: the compositor launched {launches} times ({len(recorded)} recorded), "
             f"expected {SPP} (one per sample)")
    if tuple(img.shape) != (WIDTH, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        fail(f"{name}: the frame is not a finite [{WIDTH}, {WIDTH}, 3] image")
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(100, 200))
    times = cuda_times(lambda: frame(next(seeds)), 10)
    frame_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    img1 = frame(0, spp=1, jitter=False)
    psnr_exact = psnr_db(img1.reshape(-1, 3)[sel], exact)
    psnr_fused = psnr_db(img1, fused_img)
    busy = None
    if out:
        busy = device_profile(lambda i: frame(300 + i), out, f"chip_smoke_{name}_profile.txt")
    rows = []
    for a in recorded:
        tensors, kw = api.split(a)
        row = check_fwd12(api, tensors, kw)
        row.update(tiles=int(tensors[0].shape[0]), rays=int(tensors[0].shape[1]),
                   S=int(tensors[-1].shape[1]), **work12(api, tensors, kw))
        rows.append(row)
        phase(f"kernel_on_{name}_inputs", **row)
    bad = [r_ for r_ in rows if not r_["ok"]]
    if bad:
        fail(f"{name}: the forward kernel disagrees with its plain version on "
             f"{len(bad)} of the frame's {len(rows)} launches")
    synth = fwd12_synthetic(backend, name, img.device, details)
    source = "composite_fwd" if backend == "pallas" else "composite2_fwd"
    ptxas = [{k: row_.get(k) for k in ("args", "registers", "spill_stores", "spill_loads",
                                       "stack")}
             for row_ in details.get("build", {}).get(source, {}).get("ptxas", [])
             if row_["kernel"] == "fwd12_kernel"]
    phase(
        name, launches=launches, frame_ms=frame_ms, frame_ms_min=times[0],
        frame_ms_max=times[-1], mrays_per_s=WIDTH * WIDTH * SPP / (frame_ms / 1e3) / 1e6,
        peak_mem_gib=peak, mean_radiance=float(img.mean()),
        psnr_vs_exact_db=psnr_exact, psnr_vs_fused_db=psnr_fused,
        device_busy_ms=busy, device_idle_share=None if busy is None else 1.0 - busy / frame_ms,
        kernel_ms=sum(r_["ms"] for r_ in rows), plain_ms=sum(r_["plain_ms"] for r_ in rows),
        rays_outside_tol=sum(r_[x]["rays_outside_tol"] for r_ in rows for x in ("L", "beta")),
        fwd_synthetic_ms={r_["case"]: r_["ms"] for r_ in synth},
        fwd_synthetic_rays_outside_tol=sum(r_[x]["rays_outside_tol"] for r_ in synth
                                           for x in ("L", "beta")),
        fwd_synthetic_max_abs_err=max(r_[x]["max_abs"] for r_ in synth for x in ("L", "beta")),
        fwd_ptxas=ptxas, seconds=round(time.perf_counter() - t_phase, 2),
    )
    details[name] = dict(times=times, launches=rows, fwd_ptxas=ptxas)
    return dict(
        launches=launches, ms=sum(r_["ms"] for r_ in rows),
        plain_ms=sum(r_["plain_ms"] for r_ in rows),
        bound_ms=sum(r_["fwd_bound_ms"] for r_ in rows),
        bound_by=max(rows, key=lambda r_: r_["fwd_bound_ms"])["fwd_bound_by"],
        max_abs_err=max(r_[x]["max_abs"] for r_ in rows for x in ("L", "beta")),
    )


def v12_train_step(backend, name, camera, dev, details, out=None) -> dict:
    """Phase 13 / 15: the full-width train step through ``backend``
    (1 spp, L1 against a zero image, gradients of all five parameters);
    its forward and backward launches' own inputs are replayed against the
    plain versions, then again with max_depth 8. Returns the backward
    kernel's numbers and the forward's replay errors."""
    from volprim_tpu_torch import interop, train
    from volprim_tpu_torch.models import rf_tiled
    from volprim_tpu_torch.scene import synthetic

    t_phase = time.perf_counter()
    api = V12Api(backend)
    cfg = rf_tiled.RFTiledConfig(backend=backend, **V12)
    base = synthetic.make_scene(N_PRIMS, device=dev)
    params = {
        "centers": base.centers, "scales": base.scales, "quats": base.quats,
        "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"],
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def step(seed):
        for p in params.values():
            p.grad = None
        img = train.render_cameras(train.to_scene(params, base), [camera], cfg, spp=1,
                                   seed=seed)
        loss = torch.mean(torch.abs(img))  # L1 against a zero image (bench.py)
        loss.backward()
        return loss.detach()

    (loss0, n_bwd, rec_b), n_fwd, rec_f = record_launches(
        api.fwd_mod, "_launch", api.fwd_counter,
        lambda: record_launches(api.bwd_mod, "_launch_bwd", api.bwd_counter, lambda: step(0)),
    )
    counts = (n_fwd, n_bwd)
    if counts != (1, 1) or (len(rec_f), len(rec_b)) != (1, 1):
        fail(f"{name}: the step launched (forward, backward) {counts} times, expected (1, 1)")
    grad_max = {}
    for k in interop.TRAIN_KEYS:
        g = params[k].grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"{name}: the gradient of {k} is missing, not finite or all zero")
        grad_max[k] = float(g.abs().max())
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(1, 100))
    times = cuda_times(lambda: step(next(seeds)), 5, warmup=1)
    step_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = None
    if out:
        busy = device_profile(lambda i: step(10 + i), out, f"chip_smoke_{name}_profile.txt")
    del params, base
    a = list(rec_b[0])
    del rec_f, rec_b
    tensors, kw = api.split(a, n_extra=2)
    tensors, cot = tensors[:-2], tensors[-2:]
    w = work12(api, tensors, kw)
    reps = {}
    for md in (kw["max_depth"], 8):
        kw_md = dict(kw, max_depth=md)
        timed = 10 if md == kw["max_depth"] else 0
        f_row = check_fwd12(api, tensors, kw_md, reps=timed)
        b_row = check_bwd12(api, tensors, cot, kw_md, reps=timed)
        b_rows = b_row.pop("rows")
        reps[md] = (f_row, b_row)
        phase(f"kernels_on_{name}_inputs", max_depth=md, fwd=f_row, bwd=b_row)
        details[f"{name}_max_depth_{md}"] = dict(fwd=f_row, bwd=b_row, bwd_rows=b_rows)
        if not (f_row["ok"] and b_row["ok"]):
            fail(f"{name}: a kernel disagrees with its plain version on the step's inputs "
                 f"at max_depth {md}")
    f_row, b_row = reps[kw["max_depth"]]
    shape = dict(tiles=int(tensors[0].shape[0]), rays=int(tensors[0].shape[1]),
                 S=int(tensors[-1].shape[1]))
    del tensors, cot
    synth = bwd12_synthetic(backend, name, dev, details)
    source = "composite_bwd" if backend == "pallas" else "composite2_bwd"
    ptxas = [{k: row_.get(k) for k in ("args", "registers", "spill_stores", "spill_loads",
                                       "stack")}
             for row_ in details.get("build", {}).get(source, {}).get("ptxas", [])
             if row_["kernel"] == "bwd12_kernel"]
    phase(
        name, launches_fwd=counts[0], launches_bwd=counts[1], loss=float(loss0),
        step_ms=step_ms, step_ms_min=times[0], step_ms_max=times[-1], peak_mem_gib=peak,
        device_busy_ms=busy, device_idle_share=None if busy is None else 1.0 - busy / step_ms,
        grad_max_abs=grad_max, **shape,
        fwd_kernel_ms=f_row["ms"], bwd_kernel_ms=b_row["ms"],
        bwd_elements_outside_band=sum(reps[m][1]["elements_outside_band"] for m in reps),
        bwd_bit_identical=all(reps[m][1]["bit_identical"] for m in reps),
        bwd_synthetic_ms={r_["R"]: r_["ms"] for r_ in synth}, bwd_ptxas=ptxas,
        seconds=round(time.perf_counter() - t_phase, 2), **w,
    )
    details[name] = dict(step_times=times, work=w, bwd_ptxas=ptxas)
    return dict(
        launches=counts[1], ms=b_row["ms"], plain_ms=b_row["plain_ms"],
        bound_ms=w["bwd_bound_ms"], bound_by=w["bwd_bound_by"],
        max_abs_err=max([reps[m][1]["max_abs"] for m in reps] + [r_["max_abs"] for r_ in synth]),
        fwd_max_abs_err=max(reps[m][0][x]["max_abs"] for m in reps for x in ("L", "beta")),
        fwd_ms=f_row["ms"], fwd_plain_ms=f_row["plain_ms"], fwd_bound_ms=w["fwd_bound_ms"],
    )


@torch.no_grad()
def check_fwd3(composite3, a, reps=10) -> dict:
    """A recorded ``composite3._launch`` argument tuple replayed through the
    wrapper against the plain version (in TILE_CHUNK tiles: memory), with
    both times: L and beta within ATOL / RTOL (KILL_FLIP), the walked and
    live counts equal."""
    d8, pf, sh3, n_seg_t = a[:4]
    kw = dict(zip(("seg", "extent2", "max_depth", "beta_kill", "sh_k", "compact",
                   "order_band", "early_exit"), a[4:]))
    got = composite3.forward3(d8, pf, sh3, n_seg_t, **kw)
    want = [torch.cat(x) for x in zip(*(
        composite3._forward3_reference(d8[c], pf[c], sh3[c], n_seg_t[c], *a[4:])
        for c in (slice(t0, t0 + TILE_CHUNK) for t0 in range(0, d8.shape[0], TILE_CHUNK))
    ))]
    torch.cuda.synchronize()
    n_rays = d8.shape[0] * d8.shape[2]
    row = dict(tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
               compact=kw["compact"], order_band=kw["order_band"], early_exit=kw["early_exit"],
               L=compare(got[0], want[0], n_rays), beta=compare(got[1], want[1], n_rays),
               walked_equal=bool(torch.equal(got[2], want[2].to(got[2].dtype))),
               live_equal=bool(torch.equal(got[3], want[3].to(got[3].dtype))),
               walked_mean=float(got[2].float().mean()), live_mean=float(got[3].float().mean()),
               walked=int(got[2].sum()), live=int(got[3].sum()),
               tiles_stopped_early=int((got[2] < got[3]).sum()),
               tiles_walked_whole=int((got[2] == got[3]).sum()))
    row["ok"] = row["L"]["ok"] and row["beta"]["ok"] and row["walked_equal"] and row["live_equal"]
    del got, want
    row["ms"] = cuda_ms(lambda: composite3.forward3(d8, pf, sh3, n_seg_t, **kw), reps)
    row["plain_ms"] = cuda_ms(lambda: composite3._forward3_reference(d8, pf, sh3, n_seg_t, *a[4:]),
                              2, warmup=1)
    return row


@torch.no_grad()
def clone_check(clone, dev, details) -> dict:
    """Phase 16: the profiler's DMA-floor probe against its plain version
    at the profiler's kernel-stage tile blocks (CLONE) and at 4x their
    columns: every element equal, the time beside the bytes bound, the
    4S / S time ratio (a probe that skipped its reads would not grow), and
    torch.sum over the same tensors for scale."""
    t, r, s, rows, seg = (CLONE[k] for k in ("T", "R", "S", "rows", "seg"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    ut = torch.triu(torch.ones((seg, seg), device=dev))
    out = {}
    for s_ in (s, 4 * s):
        args = (
            torch.randint(0, s_ // seg + 1, (t,), generator=gen, device=dev, dtype=torch.int32),
            torch.randn((t, 8, r), generator=gen, device=dev),
            torch.randn((t, 16, s_), generator=gen, device=dev),
            torch.randn((t, rows, s_), generator=gen, device=dev).to(torch.bfloat16),
            ut,
        )
        got, want = clone.clone(*args), clone.clone_reference(*args)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        err = float((got - want).abs().max())
        del got, want
        nbytes = t * (8 * r * 4 + 16 * s_ * 4 + rows * s_ * 2) + t * 4 + seg * seg * 4 + t * r * 32
        row = dict(T=t, R=r, S=s_, sh_rows=rows, elements_differing=differ, max_abs_err=err,
                   ms=cuda_ms(lambda: clone.clone(*args), 20),
                   plain_ms=cuda_ms(lambda: clone.clone_reference(*args), 20),
                   torch_sum_ms=cuda_ms(lambda: [x.sum() for x in args[1:4]], 20),
                   bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")
        out[s_] = row
        phase("clone_kernel", **row)
        if differ:
            fail(f"clone differs from its plain version in {differ} elements at S={s_}")
    ratio = out[4 * s]["ms"] / out[s]["ms"]
    phase("clone", ratio_4s_over_s=ratio, bound_ratio=out[4 * s]["bound_ms"] / out[s]["bound_ms"])
    details["clone"] = dict(rows=list(out.values()), ratio_4s_over_s=ratio)
    if ratio < 1.5:
        fail(f"clone at 4S took {ratio:.2f}x its time at S (under 1.5x): its reads are not timed")
    return dict(out[s], ratio_4s_over_s=ratio)


def profiler_phase(composite3, clone, rf_tiled, scene, camera, exact, sel, details) -> dict:
    """Phase 17: the ported profiler in-process at its defaults plus the
    stage stops, the coarse cull, the probe and the segment statistics
    (counts set to 0 just before, read just after); then one frame of its
    configuration (refine 0.125) with every compositor launch, base and
    refine pass, replayed against the plain version, and its PSNR against
    phase 5's exact subsample beside the same configuration at refine 0."""
    from volprim_tpu_torch.tools import profile_rf

    t_phase = time.perf_counter()
    composite3.composite_tiles3.launches = 0
    clone.clone.launches = 0
    results = profile_rf.main(["--reps", "3", "--stages", PROFILER_STAGES])
    torch.cuda.synchronize()
    launches = dict(composite3=composite3.composite_tiles3.launches,
                    clone=clone.clone.launches)
    want = [st for st in PROFILER_STAGES.split(",") if st != "segstats"]
    if sorted(results) != sorted(want) or not all(math.isfinite(v) for v in results.values()):
        fail(f"profile_rf printed {sorted(results)}, expected {sorted(want)}, all finite")
    if not (launches["composite3"] > 0 and launches["clone"] > 0):
        fail(f"the profiler's run launched {launches}: a kernel of its path never ran")
    phase("profile_rf", stage_ms=results, launches=launches)

    cfg = profile_rf.config(profile_rf._parser().parse_args([]))
    state = rf_tiled.build_state(scene, cfg)
    img, n_launch, recorded = record_launches(
        composite3, "_launch", composite3.composite_tiles3,
        lambda: rf_tiled.render_state(state, camera, cfg, None, spp=SPP, seed=1),
    )
    if n_launch != len(recorded) or n_launch < 2 or not bool(torch.isfinite(img).all()):
        fail(f"the profiler's frame launched the compositor {n_launch} times "
             "(a base and a refine pass expected) or is not finite")
    rows = []
    for a in recorded:
        row = check_fwd3(composite3, a)
        rows.append(row)
        phase("kernel_on_profiler_frame_inputs", **row)
    psnr = {}
    for frac in (cfg.refine_fraction, 0.0):
        c = dataclasses.replace(cfg, refine_fraction=frac)
        st = state if frac else rf_tiled.build_state(scene, c)
        img1 = rf_tiled.render_state(st, camera, c, None, spp=1, seed=0, jitter=False)
        psnr[frac] = psnr_db(img1.reshape(-1, 3)[sel], exact)
    phase("profiler_frame", launches=n_launch, refine_fraction=cfg.refine_fraction,
          psnr_vs_exact_db=psnr[cfg.refine_fraction], psnr_vs_exact_db_refine_0=psnr[0.0],
          seconds=round(time.perf_counter() - t_phase, 2))
    details["profile_rf"] = dict(stage_ms=results, launches=launches, frame_launches=rows,
                                 psnr=psnr)
    if not all(r_["ok"] for r_ in rows):
        fail("the compositor disagrees with its plain version on the profiler frame's inputs")
    if not psnr[cfg.refine_fraction] >= psnr[0.0]:
        fail(f"refinement lowered the PSNR vs exact: {psnr}")
    return dict(launches=launches, rows=rows)


def band_frames(composite3, rf_tiled, scene, camera, exact, sel, details) -> list:
    """Phase 18: bench.py's two order-band frames (BAND at 4096 and 8192
    candidates): the counted frame, every forward launch replayed against
    the plain version, the median of 10 frames, peak memory, and PSNR
    against phase 5's exact subsample beside the same frame unbanded."""
    out = []
    for mc in BAND_POINTS:
        t_phase = time.perf_counter()
        cfg = rf_tiled.RFTiledConfig(max_candidates=mc, **BAND)
        state = rf_tiled.build_state(scene, cfg)

        def frame(seed, spp=SPP, jitter=True, c=cfg, st=state):
            return rf_tiled.render_state(st, camera, c, None, spp=spp, seed=seed, jitter=jitter)

        img, launches, recorded = record_launches(
            composite3, "_launch", composite3.composite_tiles3, lambda: frame(1))
        if launches != len(recorded) or not launches:
            fail(f"band frame mc={mc}: the compositor launched {launches} times")
        if tuple(img.shape) != (WIDTH, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            fail(f"band frame mc={mc}: not a finite [{WIDTH}, {WIDTH}, 3] image")
        torch.cuda.reset_peak_memory_stats()
        seeds = iter(range(100, 200))
        times = cuda_times(lambda: frame(next(seeds)), 10)
        frame_ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**30
        c0 = dataclasses.replace(cfg, order_band=0)
        psnr_band = psnr_db(frame(0, 1, False).reshape(-1, 3)[sel], exact)
        psnr_0 = psnr_db(rf_tiled.render_state(state, camera, c0, None, spp=1, seed=0,
                                               jitter=False).reshape(-1, 3)[sel], exact)
        rows = []
        for a in recorded:
            row = check_fwd3(composite3, a)
            row.update(fwd_work(composite3, a))
            rows.append(row)
            phase("kernel_on_band_frame_inputs", max_candidates=mc, **row)
        res = dict(
            max_candidates=mc, order_band=cfg.order_band, launches=launches,
            frame_ms=frame_ms, frame_ms_min=times[0], frame_ms_max=times[-1],
            mrays_per_s=WIDTH * WIDTH * SPP / (frame_ms / 1e3) / 1e6, peak_mem_gib=peak,
            psnr_vs_exact_db=psnr_band, psnr_vs_exact_db_band_0=psnr_0,
            kernel_ms=sum(r_["ms"] for r_ in rows), plain_ms=sum(r_["plain_ms"] for r_ in rows),
            bound_ms=sum(r_["fwd_bound_ms"] for r_ in rows),
            bound_by=max(rows, key=lambda r_: r_["fwd_bound_ms"])["fwd_bound_by"],
            max_abs_err=max(r_[x]["max_abs"] for r_ in rows for x in ("L", "beta")),
            rays_outside_tol=sum(r_[x]["rays_outside_tol"] for r_ in rows for x in ("L", "beta")),
            seconds=round(time.perf_counter() - t_phase, 2),
        )
        phase("band_frame", **res)
        details[f"band_frame_{mc}"] = dict(res, times=times, launches=rows)
        out.append(res)
        if not all(r_["ok"] for r_ in rows):
            fail(f"band frame mc={mc}: the forward kernel disagrees with its plain version")
        if not psnr_band > psnr_0:
            fail(f"band frame mc={mc}: order_band {cfg.order_band} did not raise the PSNR vs "
                 f"exact ({psnr_band:.3f} vs {psnr_0:.3f} dB unbanded)")
        del state, recorded
    return out


@torch.no_grad()
def cull_identity(composite3, args, kw) -> dict:
    """Both kernels on the backward's recorded ``args`` = (d8, pf, sh3,
    n_seg_t, g_l, g_beta) as packed and again with row 14 set to +inf,
    which makes every column's cull radius infinite: no warp cull (the
    radius is all that the culls read of row 14; compaction must be off).
    A cull that drops no hit leaves every output bit-identical: the
    forward's per-ray sums run in stream order and the backward's column
    sums in a fixed order."""
    d8, pf, sh3, n_seg_t, g_l, g_beta = args
    if kw["compact"]:
        raise ValueError("cull_identity needs compaction off (it reads row 14 too)")
    pf_inf = pf.clone()
    pf_inf[:, 14] = float("inf")
    out = {}
    for tag, p in (("cull", pf), ("no_cull", pf_inf)):
        out[tag] = (*composite3.forward3(d8, p, sh3, n_seg_t, **kw),
                    *composite3.composite_tiles3_bwd(d8, p, sh3, n_seg_t, g_l, g_beta, **kw))
    del pf_inf
    names = ("L", "beta", "walked", "live", "gpf", "gsh")
    res = {n: bool(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b))
           for n, a, b in zip(names, out["cull"], out["no_cull"])}
    res["ok"] = all(res.values())
    return res


def replay_train_step(composite3, camera, dev, details, name, quat_norm=None,
                      **cfg_kw) -> dict:
    """Phase 7's train step with ``cfg_kw`` over TRAIN (phase 19: order_band
    16; phase 20: compaction off, every quaternion scaled to ``quat_norm``):
    launch counts, finite nonzero gradients, step time, then its forward and
    backward launches' own inputs replayed against the plain versions (the
    backward held to the f64 yardstick by compare_grads). Prints phase
    ``name``.

    With ``quat_norm`` (phase 20) the warp cull is also held to
    :func:`cull_identity`. On those inputs one ray's weight lands on
    log(beta_kill) in the plain version's cumsum and just above it in the
    kernels' sequential sum (a KILL_FLIP, which the forward's check
    allows): the backward's comparison excuses that ray's columns
    (:func:`kill_flips`) and counts them."""
    from volprim_tpu_torch import interop, train
    from volprim_tpu_torch.models import rf_tiled
    from volprim_tpu_torch.scene import synthetic

    t_phase = time.perf_counter()
    cfg = rf_tiled.RFTiledConfig(**dict(TRAIN, **cfg_kw))
    base = synthetic.make_scene(N_PRIMS, device=dev)
    if quat_norm is not None:
        q = base.quats
        base = dataclasses.replace(
            base, quats=q * (quat_norm / torch.linalg.vector_norm(q, dim=-1, keepdim=True)))
    params = {
        "centers": base.centers, "scales": base.scales, "quats": base.quats,
        "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"],
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def step(seed):
        for p in params.values():
            p.grad = None
        img = train.render_cameras(train.to_scene(params, base), [camera], cfg, spp=1,
                                   seed=seed)
        loss = torch.mean(torch.abs(img))  # L1 against a zero image (bench.py)
        loss.backward()
        return loss.detach()

    (loss0, n_bwd, rec_b), n_fwd, rec_f = record_launches(
        composite3, "_launch", composite3.composite_tiles3,
        lambda: record_launches(composite3, "_launch_bwd", composite3.composite_tiles3_bwd,
                                lambda: step(0)),
    )
    if (n_fwd, n_bwd) != (1, 1) or (len(rec_f), len(rec_b)) != (1, 1):
        fail(f"{name}: the step launched (forward, backward) {(n_fwd, n_bwd)} times")
    grad_max = {}
    for k in interop.TRAIN_KEYS:
        g = params[k].grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"{name}: the gradient of {k} is missing, not finite or all zero")
        grad_max[k] = float(g.abs().max())
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(1, 100))
    times = cuda_times(lambda: step(next(seeds)), 5, warmup=1)
    step_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, base
    f_row = check_fwd3(composite3, rec_f[0])
    phase(f"fwd_kernel_on_{name}_inputs", **f_row)
    d8, pf, sh3, n_seg_t, g_l, g_beta, seg, extent2, max_depth, beta_kill, sh_k, compact, band = (
        rec_b[0])
    del rec_f, rec_b
    bkw = dict(seg=seg, extent2=extent2, max_depth=max_depth, beta_kill=beta_kill, sh_k=sh_k,
               order_band=band)
    w = work(composite3, d8, pf, sh3, n_seg_t, seg, extent2, max_depth, sh_k, compact, band)
    cmp_, bwd_ms, bwd_plain_ms = check_bwd(composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta),
                                           bkw, compact)
    rows = cmp_["gpf"].pop("rows")
    ident = None
    if quat_norm is not None:
        ident = cull_identity(composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta),
                              dict(bkw, compact=compact))
    res = dict(
        launches_fwd=n_fwd, launches_bwd=n_bwd, order_band=band, compact=bool(compact),
        quat_norm=quat_norm, cull_identity=ident, loss=float(loss0),
        step_ms=step_ms, step_ms_min=times[0], step_ms_max=times[-1], peak_mem_gib=peak,
        grad_max_abs=grad_max, fwd_kernel_ms=f_row["ms"], bwd=cmp_, ms=bwd_ms,
        plain_ms=bwd_plain_ms, seconds=round(time.perf_counter() - t_phase, 2), **w,
    )
    phase(name, **res)
    details[name] = dict(res, times=times, bwd_rows=rows, fwd=f_row)
    if ident is not None and not ident["ok"]:
        fail(f"{name}: the warp cull dropped a hit (outputs with and without it differ: "
             f"{ident})")
    if not (f_row["ok"] and cmp_["ok"]):
        fail(f"{name}: a kernel disagrees with its plain version on the step's inputs")
    return dict(res, fwd=f_row)



# ---- the 3DGS-asset path (phases 21-25) ------------------------------------

# where phases 21 and 25 write their PLY, cameras, images and assets (under
# build/, which .gitignore lists)
ASSET_DIR = os.path.join("build", "chip_smoke_asset")
# JAX's PLY round-trip tolerances (tests/test_scene_io.py:41-65)
PLY_RTOL = dict(centers=(1e-5, 0.0), scales=(1e-5, 0.0), quats=(1e-5, 1e-6),
                opacities=(1e-4, 1e-5), sh_coeffs=(1e-4, 1e-5))
# the xla route against the v1 kernel (JAX's test_pallas_backend_matches_xla
# and test_pallas_gradients_match_xla)
XLA_V1_RTOL, XLA_V1_ATOL, XLA_V1_GRAD = 1e-3, 2e-3, 2e-3
# the gradients the f64 rule gates in phase 23: those that reach the
# primitives without the quadric feature rows, whose plain-autograd sums
# cancel in f32 at the headline scales in JAX's xla route as in the port's
XLA_GATED = ("opacities", "sh_coeffs")
# the other three (centers, scales, quats) are gated on their projection
# on the f64 gradient, <g, g64> / <g64, g64>, within XLA_PROJ_TOL of 1:
# f32 noise leaves it near 1 (JAX's xla route at the headline scales,
# 64x64: 0.82 / 0.95 / 0.93, tests/test_torch_xla_headline.py; the port's
# on the card at 512x512: 0.96 / 1.06 / 0.98), a zero, shrunk, scaled or
# sign-flipped gradient does not; and on an RMS deviation from f64 at most
# XLA_RMS_OVER_V1 times the v1 kernel's (on the card 1.5x / 10.1x / 5.0x),
# which added noise of the gradient's own size does not meet
XLA_PROJ_TOL, XLA_RMS_OVER_V1 = 0.3, 20.0
# the refine CLI's steps and the refs' samples (phase 8's protocol)
CLI_STEPS, CLI_REF_SPP = 8, 4


def scene_arrays(scene) -> dict:
    return dict(centers=scene.centers, scales=scene.scales, quats=scene.quats,
                **scene.attrs)


def f32_cull(state):
    """An f64 state with its cull geometry in f32, which the cull takes:
    the f64 yardstick of a frame selects the f32 frame's shortlists."""
    return dataclasses.replace(state, **{k: getattr(state, k).float() for k in (
        "cull_centers", "cull_radii", "sup_centers", "sup_radii", "suprows")})


class _V1Plain64(torch.autograd.Function):
    """The v1 compositor's plain versions in f64, TILE_CHUNK tiles at a
    time (composite_tiles_reference forward, composite_tiles_bwd_reference
    backward): the yardstick of the xla route in phases 22-23, code apart
    from the route it measures."""

    @staticmethod
    def forward(ctx, fa, fb, fc, basis, pf, opac, sh3, seg, extent2, max_depth, beta_kill):
        from volprim_tpu_torch.kernels import composite

        x = tuple(v.double() for v in (fa, fb, fc, basis, pf, opac, sh3))
        kw = dict(seg=seg, extent2=extent2, max_depth=max_depth, beta_kill=beta_kill)
        parts = [composite.composite_tiles_reference(*(v[i:i + TILE_CHUNK] for v in x), **kw)
                 for i in range(0, x[0].shape[0], TILE_CHUNK)]
        ctx.save_for_backward(*x)
        ctx.kw = kw
        ctx.dtypes = (pf.dtype, opac.dtype, sh3.dtype)
        return torch.cat([q[0] for q in parts]), torch.cat([q[1] for q in parts])

    @staticmethod
    def backward(ctx, g_l, g_beta):
        from volprim_tpu_torch.kernels import composite_vjp

        x = ctx.saved_tensors
        parts = [composite_vjp.composite_tiles_bwd_reference(
            *(v[i:i + TILE_CHUNK] for v in x), g_l[i:i + TILE_CHUNK].double(),
            g_beta[i:i + TILE_CHUNK].double(), **ctx.kw)
            for i in range(0, x[0].shape[0], TILE_CHUNK)]
        grads = [torch.cat([q[j] for q in parts]).to(dt) for j, dt in enumerate(ctx.dtypes)]
        return (None,) * 4 + tuple(grads) + (None,) * 4


def _v1_plain64(fa, fb, fc, basis, pf, opac, sh3, seg=256, extent2=9.0, max_depth=128,
                beta_kill=0.01):
    """:class:`_V1Plain64` with ``composite_vjp.composite_tiles_ad``'s signature."""
    return _V1Plain64.apply(fa, fb, fc, basis, pf, opac, sh3, seg, extent2, max_depth,
                            beta_kill)


def v1_plain64_frame(rf_tiled, scene, camera, cfg, seed, spp=SPP, params=None, jitter=True):
    """``render_state`` of ``scene`` in f64 (its cull geometry in f32: the
    f32 frames' shortlists) through backend='pallas' with the v1 kernel's
    wrapper replaced by :class:`_V1Plain64`: the f64 yardstick of the xla
    route and of the v1 kernel. With ``params`` (f64 leaves of the five
    trained arrays) the frame is differentiable in them."""
    from volprim_tpu_torch.kernels import composite_vjp
    from volprim_tpu_torch.ops import quadric, sh

    p = params or {}
    s64 = dataclasses.replace(
        scene, **{k: p.get(k, getattr(scene, k)).double() for k in ("centers", "scales", "quats")},
        attrs={k: p.get(k, v).double() for k, v in scene.attrs.items()})
    cfg = dataclasses.replace(cfg, backend="pallas")
    # the ray features and SH basis of the (f32) rays formed in f64, as the
    # xla route forms them from f64 rays: q cancels their f32 rounding too
    orig = composite_vjp.composite_tiles_ad, quadric.ray_features, sh.eval_basis
    composite_vjp.composite_tiles_ad = _v1_plain64
    quadric.ray_features = lambda o, d: orig[1](o.double(), d.double())
    sh.eval_basis = lambda d, degree: orig[2](d.double(), degree)
    try:
        return rf_tiled.render_state(f32_cull(rf_tiled.build_state(s64, cfg)), camera, cfg,
                                     None, spp=spp, seed=seed, jitter=jitter)
    finally:
        composite_vjp.composite_tiles_ad, quadric.ray_features, sh.eval_basis = orig


def grad_stats(g, y) -> dict:
    """A gradient ``g`` against its f64 yardstick ``y``: largest and RMS
    deviation over y's largest magnitude, and the projection of g on y."""
    scale = y.abs().max()
    d = (g - y).abs() / scale
    return dict(max=float(d.max()), rms=float(d.square().mean().sqrt()),
                proj=float((g * y).sum() / (y * y).sum()))


def asset_io(scene, details) -> dict:
    """Phase 21: save_ply of the headline scene, load_ply through the
    native parser and through numpy (bit-equal to each other and within
    JAX's round-trip tolerances of the scene), and JSONCameraSpecsIO
    write / load of the headline camera and 7 orbit cameras."""
    from volprim_tpu_torch import native
    from volprim_tpu_torch.scene import JSONCameraSpecsIO, load_ply, save_ply, synthetic

    os.makedirs(ASSET_DIR, exist_ok=True)
    ply_path = os.path.join(ASSET_DIR, "headline.ply")
    cam_path = os.path.join(ASSET_DIR, "cameras.json")
    secs = {}
    t0 = time.perf_counter()
    save_ply(scene, ply_path)
    secs["save_ply"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native.get() is None:
        fail("the native PLY parser did not build")
    secs["native_build"] = time.perf_counter() - t0
    loaded = {}
    for tag, use_native in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        loaded[tag] = load_ply(ply_path, device=scene.device, use_native=use_native)
        torch.cuda.synchronize()
        secs[f"load_ply_{tag}"] = time.perf_counter() - t0
    a, b, want = (scene_arrays(s) for s in (loaded["native"], loaded["numpy"], scene))
    if sorted(a) != sorted(want) or sorted(b) != sorted(want):
        fail(f"load_ply read {sorted(a)} / {sorted(b)}, expected {sorted(want)}")
    bit_equal = all(torch.equal(a[k], b[k]) for k in want)
    err = {}
    for k, (rtol, atol) in PLY_RTOL.items():
        e = (a[k] - want[k]).abs() - rtol * want[k].abs()
        err[k] = float(e.max())
        if err[k] > atol:
            fail(f"the PLY round trip moved {k} by more than rtol {rtol} / atol {atol}")
    cams = synthetic.orbit_cameras(WIDTH, 8)
    t0 = time.perf_counter()
    JSONCameraSpecsIO.write(cams, cam_path)
    back = JSONCameraSpecsIO.load(cam_path)
    secs["cameras_json"] = time.perf_counter() - t0
    cam_err = max(float(np.abs(c.to_world - d.to_world).max()) for c, d in zip(cams, back))
    same = [(c.name, c.width, c.height) == (d.name, d.width, d.height)
            and abs(c.focal_length - d.focal_length) < 1e-9 for c, d in zip(cams, back)]
    res = dict(prims=scene.num_prims, ply_bytes=os.path.getsize(ply_path),
               native_equals_numpy=bit_equal, roundtrip_excess=err, cameras=len(back),
               camera_to_world_max_err=cam_err, seconds={k: round(v, 3) for k, v in secs.items()})
    phase("asset_io", **res)
    details["asset_io"] = res
    if not bit_equal:
        fail("the native and the numpy PLY parsers disagree")
    if len(back) != 8 or not all(same) or cam_err > 1e-12:
        fail("the cameras.json round trip changed a camera")
    return dict(ply=ply_path, cameras=cam_path)


def launch_rays(route, args, out):
    """(directions [T, R, 3], beta [T, R]) of one compositor call: the
    fused route's (composite3's wrapper or launch) rays are rows 0-2 of
    its first argument d8 [T, 8, R]; the xla route's
    (``_composite_tiles_xla``) d [T, RT, 3] is its second."""
    d = args[0][:, :3].transpose(1, 2) if route == "fused" else args[1]
    return d.detach(), out[1].detach()


def beta_image(camera, rays):
    """The betas the compositors returned, placed on the film by their
    rays' directions: ``rays`` is a list of (d [..., 3], beta [...]) of
    pixel-center rays; each direction is projected back through the
    camera (in f64) to its pixel. Returns (beta [H, W], rays per pixel
    [H, W]), independent of the renderer's tile order."""
    h, w = camera.height, camera.width
    d = torch.cat([x.reshape(-1, 3) for x, _ in rays]).double()
    beta = torch.cat([b.reshape(-1) for _, b in rays]).double()
    rot = torch.as_tensor(camera.to_world[:3, :3], dtype=torch.float64, device=d.device)
    v = d @ rot  # the camera-frame direction, R^T d
    px = (w / 2.0 - camera.cx) - camera.focal_length * v[:, 0] / v[:, 2]
    py = (h / 2.0 - camera.cy) - camera.focal_length * v[:, 1] / v[:, 2]
    ix, iy = torch.floor(px).long(), torch.floor(py).long()
    if bool(((ix < 0) | (ix >= w) | (iy < 0) | (iy >= h)).any()):
        fail("emitter: a compositor ray points off the film")
    flat = iy * w + ix
    img = torch.zeros(h * w, dtype=torch.float64, device=d.device).index_put_(
        (flat,), beta, accumulate=True)
    count = torch.zeros(h * w, dtype=torch.int64, device=d.device).index_put_(
        (flat,), torch.ones_like(flat), accumulate=True)
    return img.reshape(h, w), count.reshape(h, w)


def xla_frame(rf_tiled, rf, scene, camera, exact, sel, o_sel, d_sel, details, out=None) -> dict:
    """Phase 22: the V12 frame through backend='xla' (plain PyTorch):
    median of 10 frames, peak memory, PSNR against phase 5's exact
    subsample; the same frame through the v1 kernel within JAX's
    backend tolerance (else both held to the v1 plain version in f64 on
    the same shortlists, :func:`v1_plain64_frame`: the xla frame's RMS
    deviation within 2x, its largest within 4x the v1 kernel's);
    the Epanechnikov frame against the exact integrator's Epanechnikov
    subsample; order_band 16 at 4096 candidates against the same frame
    unbanded."""
    t_phase = time.perf_counter()
    cfg = rf_tiled.RFTiledConfig(backend="xla", **V12)
    state = rf_tiled.build_state(scene, cfg)

    def frame(st, c, seed, spp=SPP, jitter=True):
        return rf_tiled.render_state(st, camera, c, None, spp=spp, seed=seed, jitter=jitter)

    img = frame(state, cfg, 1)
    if tuple(img.shape) != (WIDTH, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        fail(f"xla frame: not a finite [{WIDTH}, {WIDTH}, 3] image")
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(100, 200))
    times = cuda_times(lambda: frame(state, cfg, next(seeds)), 10)
    frame_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    img1 = frame(state, cfg, 0, 1, False)
    psnr = psnr_db(img1.reshape(-1, 3)[sel], exact)
    # the step size is a memory knob: 8 tiles a step give the same image
    pairs = rf_tiled._GROUP_PAIRS
    rf_tiled._GROUP_PAIRS = 0
    try:
        img8 = frame(state, dataclasses.replace(cfg, tile_group=8), 0, 1, False)
    finally:
        rf_tiled._GROUP_PAIRS = pairs
    group_err = float((img8 - img1).abs().max())
    del img8
    # early_exit: one host read a segment and step, to stop spent tiles
    cfg_ee = dataclasses.replace(cfg, early_exit=True)
    early_exit_ms = cuda_ms(lambda: frame(state, cfg_ee, next(seeds)), 3, warmup=1)
    busy = split = None
    if out:
        busy, split = device_profile(
            lambda i: frame(state, cfg, 300 + i), out, "chip_smoke_xla_profile.txt",
            stages={rf_tiled: ("_render_tiles", "_render_shortlist", "_composite_tiles_xla")})
    # the v1 kernel on the same shortlist, offsets and features
    cfg_v1 = rf_tiled.RFTiledConfig(backend="pallas", **V12)
    img_v1 = frame(rf_tiled.build_state(scene, cfg_v1), cfg_v1, 1)
    diff = (img - img_v1).abs()
    out_tol = int((diff > XLA_V1_ATOL + XLA_V1_RTOL * img_v1.abs()).sum())
    v1 = dict(max_abs=float(diff.max()), elements_outside_tol=out_tol)
    if out_tol:  # the q cancellation: both against the v1 plain version in f64
        with torch.no_grad():
            yard = v1_plain64_frame(rf_tiled, scene, camera, cfg_v1, 1)
        dx, dv = (img - yard).abs(), (img_v1 - yard).abs()
        v1.update(xla_vs_f64_max=float(dx.max()), v1_vs_f64_max=float(dv.max()),
                  xla_vs_f64_rms=float(dx.square().mean().sqrt()),
                  v1_vs_f64_rms=float(dv.square().mean().sqrt()))
        v1["ok"] = (v1["xla_vs_f64_rms"] <= 2.0 * v1["v1_vs_f64_rms"]
                    and v1["xla_vs_f64_max"] <= 4.0 * v1["v1_vs_f64_max"])
        del yard
    else:
        v1["ok"] = True
    del img_v1
    # the Epanechnikov kernel against the exact integrator's
    cfg_e = dataclasses.replace(cfg, kernel_type="epanechnikov")
    st_e = rf_tiled.build_state(scene, cfg_e)
    img_e = frame(st_e, cfg_e, 0, 1, False)
    exact_e = rf.radiance(scene, None, o_sel, d_sel, rf.RFConfig(
        max_depth=128, kernel_type="epanechnikov", chunk_size=2048))
    psnr_e = psnr_db(img_e.reshape(-1, 3)[sel], exact_e)
    times_e = cuda_times(lambda: frame(st_e, cfg_e, next(seeds)), 3, warmup=1)
    del st_e
    # order_band 16 at 4096 candidates, beside the same frame unbanded
    psnr_b = {}
    for band in (16, 0):
        c = rf_tiled.RFTiledConfig(backend="xla", **dict(V12, max_candidates=4096,
                                                          order_band=band))
        st = rf_tiled.build_state(scene, c)
        psnr_b[band] = psnr_db(frame(st, c, 0, 1, False).reshape(-1, 3)[sel], exact)
        if band:
            band_ms = cuda_ms(lambda: frame(st, c, next(seeds)), 3, warmup=1)
        del st
    res = dict(
        frame_ms=frame_ms, frame_ms_min=times[0], frame_ms_max=times[-1],
        mrays_per_s=WIDTH * WIDTH * SPP / (frame_ms / 1e3) / 1e6, peak_mem_gib=peak,
        mean_radiance=float(img.mean()), psnr_vs_exact_db=psnr, vs_v1=v1,
        tile_group_8_max_abs_diff=group_err, early_exit_frame_ms=early_exit_ms,
        device_busy_ms=busy, device_idle_share=None if busy is None else 1.0 - busy / frame_ms,
        device_ms_by_stage=split, epanechnikov_frame_ms=float(np.median(times_e)),
        epanechnikov_psnr_vs_exact_db=psnr_e, band16_mc4096_psnr_vs_exact_db=psnr_b[16],
        band0_mc4096_psnr_vs_exact_db=psnr_b[0], band16_mc4096_frame_ms=band_ms,
        seconds=round(time.perf_counter() - t_phase, 2),
    )
    phase("xla_frame", **res)
    details["xla_frame"] = dict(res, times=times)
    if not psnr > 20.0:
        fail(f"xla frame: PSNR vs exact {psnr:.2f} dB")
    if group_err > 1e-6:
        fail(f"xla frame: 8 tiles a step changed the image by {group_err}")
    if not v1["ok"]:
        fail(f"xla frame: the xla route and the v1 kernel disagree: {v1}")
    if not psnr_e > 20.0:
        fail(f"xla frame: Epanechnikov PSNR vs exact {psnr_e:.2f} dB")
    if not psnr_b[16] >= psnr_b[0]:
        fail(f"xla frame: order_band 16 lowered the PSNR vs exact: {psnr_b}")
    return res


def xla_train_step(rf_tiled, camera, dev, details) -> dict:
    """Phase 23: the TRAIN step with V12's knobs through backend='xla'
    (1 spp, L1 against a zero image): finite nonzero gradients of all five
    parameters, step time and peak memory, and each gradient against the
    v1 kernel's in the same step, within XLA_V1_GRAD of its maximum or
    else both held to the v1 plain version in f64 on the same shortlists
    (:func:`v1_plain64_frame`): XLA_GATED with an RMS deviation within 2x
    and a largest within 4x the v1 kernel's; centers, scales and quats,
    whose plain-autograd rows cancel in f32 in JAX's xla route too
    (tests/test_torch_xla_headline.py), with a projection on the f64
    gradient within XLA_PROJ_TOL of 1 and an RMS deviation within
    XLA_RMS_OVER_V1 times the v1 kernel's; then the Epanechnikov step."""
    from volprim_tpu_torch import interop
    from volprim_tpu_torch.scene import synthetic

    t_phase = time.perf_counter()
    base = synthetic.make_scene(N_PRIMS, device=dev)

    def grads(backend, kernel="gaussian", reps=0, yard=False):
        cfg = rf_tiled.RFTiledConfig(backend=backend, kernel_type=kernel, **V12)
        src = scene_arrays(base)
        dtype = torch.float64 if yard else torch.float32
        params = {k: src[k].to(dtype).clone().requires_grad_(True) for k in interop.TRAIN_KEYS}

        def step(seed):
            for p in params.values():
                p.grad = None
            if yard:
                img = v1_plain64_frame(rf_tiled, base, camera, cfg, seed, spp=1, params=params)
            else:
                state = rf_tiled.build_state(dataclasses.replace(
                    base, centers=params["centers"], scales=params["scales"],
                    quats=params["quats"],
                    attrs={k: params[k] for k in ("opacities", "sh_coeffs")}), cfg)
                img = rf_tiled.render_state(state, camera, cfg, None, spp=1, seed=seed)
            loss = torch.mean(torch.abs(img))
            loss.backward()
            return loss.detach()

        loss = step(0)
        g = {k: params[k].grad.double() for k in interop.TRAIN_KEYS}
        row = dict(loss=float(loss))
        if reps:
            torch.cuda.reset_peak_memory_stats()
            seeds = iter(range(1, 100))
            t = cuda_times(lambda: step(next(seeds)), reps, warmup=1)
            row.update(step_ms=float(np.median(t)), step_ms_min=t[0], step_ms_max=t[-1],
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        for k, v in g.items():
            if not bool(torch.isfinite(v).all()) or not bool(v.abs().max() > 0):
                fail(f"xla train step ({backend}, {kernel}): the gradient of {k} is not "
                     "finite or all zero")
        return g, row

    g_x, row_x = grads("xla", reps=5)
    g_1, _ = grads("pallas")
    rel = {k: float((g_x[k] - g_1[k]).abs().max() / g_1[k].abs().max()) for k in g_x}
    cmp_ = dict(max_rel_to_v1=rel, ok=max(rel.values()) <= XLA_V1_GRAD)
    if not cmp_["ok"]:  # q = c - b^2/a cancels: both against the v1 plain version in f64
        t0 = time.perf_counter()
        g_64, _ = grads("pallas", yard=True)
        cmp_["yard_s"] = round(time.perf_counter() - t0, 2)
        for k in g_x:
            cmp_[k] = dict(xla=grad_stats(g_x[k], g_64[k]), v1=grad_stats(g_1[k], g_64[k]))
        cmp_["ok"] = all(
            cmp_[k]["xla"]["rms"] <= 2.0 * cmp_[k]["v1"]["rms"]
            and cmp_[k]["xla"]["max"] <= 4.0 * cmp_[k]["v1"]["max"] if k in XLA_GATED
            else abs(cmp_[k]["xla"]["proj"] - 1.0) <= XLA_PROJ_TOL
            and cmp_[k]["xla"]["rms"] <= XLA_RMS_OVER_V1 * cmp_[k]["v1"]["rms"] for k in g_x)
        del g_64
    del g_1
    _, row_e = grads("xla", kernel="epanechnikov", reps=3)
    res = dict(gaussian=row_x, vs_v1=cmp_, epanechnikov=row_e,
               grad_max_abs={k: float(v.abs().max()) for k, v in g_x.items()},
               seconds=round(time.perf_counter() - t_phase, 2))
    phase("xla_train_step", **res)
    details["xla_train_step"] = res
    if not cmp_["ok"]:
        fail(f"xla train step: the gradients disagree with the v1 kernel's: {cmp_}")
    return res


def emitter_check(composite3, rf_tiled, scene, camera, details) -> dict:
    """Phase 24: the headline fused frame (1 spp, pixel centers,
    srgb_primitives=False) with and without ConstantEmitter(ones): their
    difference, pixel by pixel, is the beta the compositor returned for
    that pixel's ray, within 1e-6 (each launch's rays placed on the film
    by their directions, :func:`beta_image`; every pixel takes one ray);
    the same on the xla route, and on the fused route with early_exit and
    compaction off (the early-exit walk, whose beta is where each tile
    stopped)."""
    from volprim_tpu_torch.ops.envmap import ConstantEmitter

    emitter = ConstantEmitter(radiance=torch.ones(3, device=scene.device))
    res = {}
    for name, route, cfg in (
        ("fused", "fused", rf_tiled.RFTiledConfig(**dict(HEADLINE, srgb_primitives=False))),
        ("xla", "xla", rf_tiled.RFTiledConfig(backend="xla", **dict(V12, srgb_primitives=False))),
        ("fused_early_exit", "fused", rf_tiled.RFTiledConfig(**dict(
            HEADLINE, srgb_primitives=False, early_exit=True, kernel_compact=False))),
    ):
        state = rf_tiled.build_state(scene, cfg)
        module, attr = ((composite3, "_launch") if route == "fused"
                        else (rf_tiled, "_composite_tiles_xla"))
        orig, rays = getattr(module, attr), []

        def recording(*a, **kw):
            out = orig(*a, **kw)
            rays.append(launch_rays(route, a, out))
            return out

        setattr(module, attr, recording)
        try:
            with_em = rf_tiled.render_state(state, camera, cfg, emitter, spp=1, jitter=False)
        finally:
            setattr(module, attr, orig)
        without = rf_tiled.render_state(state, camera, cfg, None, spp=1, jitter=False)
        beta, count = beta_image(camera, rays)
        diff = (with_em - without).double()
        err = float((diff - beta[..., None]).abs().max())
        res[name] = dict(launches=len(rays), max_abs_err=err,
                         pixels_not_one_ray=int((count != 1).sum()),
                         mean_beta=float(beta.mean()))
        del state
    phase("emitter", **res)
    details["emitter"] = res
    for route, r_ in res.items():
        if r_["pixels_not_one_ray"]:
            fail(f"emitter ({route}): {r_['pixels_not_one_ray']} pixels took no ray or several")
        if not r_["max_abs_err"] <= 1e-6:
            fail(f"emitter ({route}): image difference and beta differ by {r_['max_abs_err']}")
    return res


def _run_cli(module, argv, timeout=600):
    """``python -m volprim_tpu_torch.examples.<module> argv``: (wall s, stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"volprim_tpu_torch.examples.{module}", *argv],
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=os.getcwd()))
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"{module} {' '.join(argv)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")
    return wall, proc.stdout


def cli_phase(composite3, rf_tiled, paths, scene, dev, details) -> dict:
    """Phase 25: the port's two CLIs in subprocesses on phase 21's PLY and
    cameras. Before each fused run its tiled configuration runs in-process
    (counts set to 0 just before, read just after) and its compositor
    launches are replayed against the plain versions."""
    from volprim_tpu_torch import train
    from volprim_tpu_torch.examples import refine_3dg_dataset as refine
    from volprim_tpu_torch.examples import render_3dg_asset as render_cli
    from volprim_tpu_torch.scene import JSONCameraSpecsIO, load_asset, load_ply, save_ply
    from volprim_tpu_torch.utils.image import read_exr

    t_phase = time.perf_counter()
    ply, cams = paths["ply"], paths["cameras"]
    camera = JSONCameraSpecsIO.load(cams)[0]
    res = {}
    # render, Gaussian, tiled: the fused kernel, in-process on the scene as
    # the CLI reads it, then the CLI
    tcfg = render_cli.tiled_config(camera, 128, "gaussian")
    state = rf_tiled.build_state(load_ply(ply, device=dev), tcfg)
    with torch.no_grad():
        img, launches, recorded = record_launches(
            composite3, "_launch", composite3.composite_tiles3,
            lambda: rf_tiled.render_state(state, camera, tcfg, None, spp=2, seed=0))
    rows = [check_fwd3(composite3, a) for a in recorded]
    bound = sum(fwd_work(composite3, a)["fwd_bound_ms"] for a in recorded)
    del state, recorded
    out_dir = os.path.join(ASSET_DIR, "render_tiled")
    wall, _ = _run_cli("render_3dg_asset", ["--ply", ply, "--cameras", cams, "--output",
                                            out_dir, "--renderer", "tiled", "--spp", "2"])
    exr = torch.from_numpy(read_exr(os.path.join(out_dir, "output.exr"))).to(dev)
    res["render_tiled"] = dict(wall_s=wall, launches=launches,
                               exr_vs_in_process=float((exr - img).abs().max()),
                               fwd_max_abs_err=max(r_[x]["max_abs"] for r_ in rows
                                                   for x in ("L", "beta")),
                               fwd_ms=sum(r_["ms"] for r_ in rows),
                               fwd_plain_ms=sum(r_["plain_ms"] for r_ in rows),
                               fwd_bound_ms=bound)
    if not launches or not all(r_["ok"] for r_ in rows):
        fail(f"cli: the render CLI's fused configuration launched {launches} times or a "
             "launch disagrees with the plain version")
    if res["render_tiled"]["exr_vs_in_process"] > 1e-6:
        fail("cli: the render CLI's EXR differs from the in-process render")
    del img, exr
    # render, Epanechnikov, exact, white background
    out_dir = os.path.join(ASSET_DIR, "render_exact")
    wall, _ = _run_cli("render_3dg_asset", [
        "--ply", ply, "--cameras", cams, "--output", out_dir, "--renderer", "exact",
        "--kernel", "epanechnikov", "--white_background", "--cam_scale", "0.125"])
    exr = read_exr(os.path.join(out_dir, "output.exr"))
    res["render_exact_epanechnikov"] = dict(wall_s=wall, shape=list(exr.shape),
                                            mean=float(exr.mean()))
    if exr.shape != (WIDTH // 8, WIDTH // 8, 3) or not np.isfinite(exr).all():
        fail("cli: the exact Epanechnikov render is not a finite image of the scaled camera")
    # refine: phase 8's perturbed start against references of the scene
    rng = np.random.default_rng(8)
    start = dataclasses.replace(scene, attrs=dict(
        scene.attrs, opacities=scene.attrs["opacities"] * 0.5,
        sh_coeffs=scene.attrs["sh_coeffs"] + torch.from_numpy(
            rng.normal(0.0, 0.05, tuple(scene.attrs["sh_coeffs"].shape)).astype(np.float32)
        ).to(dev)))
    start_ply = os.path.join(ASSET_DIR, "perturbed.ply")
    save_ply(start, start_ply)
    cameras = refine.select_cameras(JSONCameraSpecsIO.load(cams), 8, 0.125)
    for kernel in ("epanechnikov", "gaussian"):
        rcfg = refine.tiled_config(cameras[0], 128, kernel)
        ref_dir = os.path.join(ASSET_DIR, f"refs_{kernel}")
        os.makedirs(ref_dir, exist_ok=True)
        with torch.no_grad():
            ref = train.render_cameras(scene, cameras, rcfg, spp=CLI_REF_SPP, seed=999)
        w = cameras[0].width
        for i, c in enumerate(cameras):
            np.save(os.path.join(ref_dir, f"{c.name}.npy"),
                    ref[:, i * w:(i + 1) * w].cpu().numpy())
        row = {}
        if kernel == "gaussian":  # the step in-process: both kernels replayed
            params = {k: v.clone().requires_grad_(True) for k, v in (
                ("opacities", start.attrs["opacities"]), ("sh_coeffs", start.attrs["sh_coeffs"]),
                ("centers", start.centers))}

            def step():
                img_ = train.render_cameras(train.to_scene(params, start), cameras, rcfg,
                                            spp=1, seed=0)
                torch.mean(torch.abs(ref - img_)).backward()

            (_, n_bwd, rec_b), n_fwd, rec_f = record_launches(
                composite3, "_launch", composite3.composite_tiles3,
                lambda: record_launches(composite3, "_launch_bwd",
                                        composite3.composite_tiles3_bwd, step))
            f_rows = [check_fwd3(composite3, a) for a in rec_f]
            # the forward takes the early-exit walk: its bound is on the
            # segments that walk reads
            f_bound = sum(fwd_work(composite3, a)["fwd_bound_ms"] for a in rec_f)
            b_rows = []
            for a in rec_b:
                d8, pf, sh3, n_seg_t, g_l, g_beta, seg, e2, md, bk, shk, compact, band = a
                w = work(composite3, d8, pf, sh3, n_seg_t, seg, e2, md, shk, compact, band)
                cmp_, ms, plain_ms = check_bwd(composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta),
                                               dict(seg=seg, extent2=e2, max_depth=md,
                                                    beta_kill=bk, sh_k=shk, order_band=band),
                                               compact)
                b_rows.append(dict(ok=cmp_["ok"], ms=ms, plain_ms=plain_ms,
                                   max_abs=max(cmp_[x]["max_abs"] for x in ("gpf", "gsh")),
                                   bwd_bound_ms=w["bwd_bound_ms"]))
            del rec_f, rec_b, params
            row.update(launches_fwd=n_fwd, launches_bwd=n_bwd,
                       fwd_ms=sum(r_["ms"] for r_ in f_rows),
                       fwd_plain_ms=sum(r_["plain_ms"] for r_ in f_rows),
                       fwd_max_abs_err=max(r_[x]["max_abs"] for r_ in f_rows
                                           for x in ("L", "beta")),
                       fwd_bound_ms=f_bound,
                       bwd_ms=sum(r_["ms"] for r_ in b_rows),
                       bwd_plain_ms=sum(r_["plain_ms"] for r_ in b_rows),
                       bwd_bound_ms=sum(r_["bwd_bound_ms"] for r_ in b_rows),
                       bwd_max_abs_err=max(r_["max_abs"] for r_ in b_rows))
            if not (n_fwd and n_bwd) or not all(r_["ok"] for r_ in f_rows + b_rows):
                fail(f"cli: the refine CLI's step launched (forward, backward) "
                     f"{(n_fwd, n_bwd)} times or a launch disagrees with its plain version")
        out_dir = os.path.join(ASSET_DIR, f"refine_{kernel}")
        wall, stdout = _run_cli("refine_3dg_dataset", [
            "--ply", start_ply, "--cameras", cams, "--images", ref_dir, "--output", out_dir,
            "--renderer", "tiled", "--kernel", kernel, "--cam_count", "8",
            "--iterations", str(CLI_STEPS), "--ref_spp", str(CLI_REF_SPP)])
        losses = [float(m) for m in re.findall(r"\| loss=([0-9.eE+-]+)", stdout)]
        asset = load_asset(os.path.join(out_dir, "refined_asset"), device=dev)
        row.update(wall_s=wall, losses=losses, refined_prims=asset["primitives"].num_prims)
        res[f"refine_{kernel}"] = row
        del asset
        if len(losses) != CLI_STEPS or not losses[-1] < losses[0]:
            fail(f"cli: refine ({kernel}) losses {losses} did not fall over {CLI_STEPS} steps")
        if row["refined_prims"] != scene.num_prims:
            fail(f"cli: the refined asset holds {row['refined_prims']} primitives")
    res["seconds"] = round(time.perf_counter() - t_phase, 2)
    phase("cli", **res)
    details["cli"] = res
    return res


# ---- 26-29. the volume-fitting path: tomography, grid volumes, CLIs ---------

# optimize_volume's defaults (8 ring cameras at 256^2, a 16^3 lattice), the
# tomography frame's visible sigma_t, and the cuts: 4 reference samples (of
# 32) and 8 steps (of 64)
VOLUME_SIGMA_T, VOLUME_REF_SPP, VOLUME_STEPS = 0.5, 4, 8
# the f32 frame against the same function in f64 on TOMO_F64_RAYS rays
TOMO_F64_RAYS, TOMO_RTOL, TOMO_ATOL = 4096, 1e-4, 1e-6
# operations a fused kernel would need: per (ray, primitive) pair of the
# tomography forward (tomography._chunk_tau: the local frame's w and p 45,
# a and t* 12, q_min 11, the extent test 11, the integral and its scrub 9,
# the weighted sum 2), and per grid sample of the scattering tracer
# (GridVolume.sample's corner indices and trilinear blend 45, a tracking
# or marching step's own arithmetic 10); each arithmetic or transcendental
# operation counts one
OPS_TOMO_PAIR, OPS_GRID_SAMPLE = 90, 55


def _generator(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _scene64(scene):
    return dataclasses.replace(scene, centers=scene.centers.double(),
                               scales=scene.scales.double(), quats=scene.quats.double(),
                               attrs={k: v.double() for k, v in scene.attrs.items()})


def tomography_frame(dev, details) -> dict:
    """Phase 26: the batch sensor through the tomography integrator at the
    CLI's full width (8 ring cameras at 256^2, a 16^3 lattice at sigma_t
    VOLUME_SIGMA_T, a constant emitter, 1 spp: 2.15e9 (ray, primitive)
    pairs); the f32 radiance on TOMO_F64_RAYS pixel-centre rays against the
    same function in f64; one Gaussian's transmittance against its closed
    form (tests/test_analytic_golden.py:133)."""
    from volprim_tpu_torch.examples import optimize_volume as ov
    from volprim_tpu_torch.models import base, render_batch, tomography
    from volprim_tpu_torch.ops.envmap import ConstantEmitter
    from volprim_tpu_torch.scene import EllipsoidsFactory, lattice_init

    cams = ov.ring_cameras(8, 256)
    prims = lattice_init(16, init_sigmat=VOLUME_SIGMA_T, device=dev)
    cfg = tomography.TomographyConfig(max_depth=-1)
    em = ConstantEmitter(radiance=torch.ones(3, device=dev))

    @torch.no_grad()
    def frame(seed=0):
        return render_batch(prims, cams, tomography.radiance, cfg, em, spp=1,
                            generator=_generator(dev, seed))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = cuda_times(frame, reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    img = frame()
    h, w = cams[0].height, cams[0].width
    rays = len(cams) * h * w
    pairs = rays * prims.num_prims
    bytes_io = rays * (2 * 3 + 3) * 4  # the rays in, the radiance out
    res = dict(rays=rays, primitives=prims.num_prims, pairs=pairs,
               bound_ms=max(pairs * OPS_TOMO_PAIR / PEAK_F32, bytes_io / PEAK_BYTES) * 1e3,
               bound_by="operations" if pairs * OPS_TOMO_PAIR / PEAK_F32
               >= bytes_io / PEAK_BYTES else "bytes",
               tomo_pairs=tomography._TOMO_PAIRS, frame_ms=float(np.median(times)),
               frame_ms_all=times, peak_gib=peak / 2**30, mean=float(img.mean()),
               partial_share=float(((img > 0.01) & (img < 0.99)).float().mean()))
    if tuple(img.shape) != (h, len(cams) * w, 3) or not bool(torch.isfinite(img).all()):
        fail(f"tomography_frame: the image is {tuple(img.shape)} or not finite")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0 + 1e-6:
        fail("tomography_frame: radiance outside [0, 1] under a unit emitter")
    # the yardstick: pixel-centre rays, every n-th of the batch, in f64
    px = (torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w).reshape(1, -1)
          + 0.5).expand(len(cams), -1)
    py = (torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w).reshape(1, -1)
          + 0.5).expand(len(cams), -1)
    o, d = base.batch_rays(cams, px, py)
    pick = torch.arange(0, rays, rays // TOMO_F64_RAYS, device=dev)
    o, d = o[pick], d[pick]
    with torch.no_grad():
        got = tomography.radiance(prims, em, o, d, cfg)
        want = tomography.radiance(_scene64(prims),
                                   ConstantEmitter(radiance=torch.ones(3, device=dev,
                                                                       dtype=torch.float64)),
                                   o.double(), d.double(), cfg)
    err = (got.double() - want).abs()
    res.update(f64_rays=int(pick.numel()), f64_max_abs_err=float(err.max()),
               f64_max_rel_err=float((err / want.abs().clamp(min=1e-30)).max()),
               f64_outside=int((err > TOMO_ATOL + TOMO_RTOL * want.abs()).sum()),
               f64_partial_rays=int(((want > 0.01) & (want < 0.99)).any(-1).sum()))
    if res["f64_outside"]:
        fail(f"tomography_frame: {res['f64_outside']} values outside rtol {TOMO_RTOL} / "
             f"atol {TOMO_ATOL} of the f64 run")
    # one Gaussian: tau = sigma_t exp(-q_min / 2) / (2 pi s^2), q_min = d^2 / s^2
    s, sigma_t, d_perp = 0.25, 3.0, 0.1
    f = EllipsoidsFactory()
    f.add(mean=[0.0, 0.0, 0.0], scale=s, sigma_t=sigma_t, albedo=0.5)
    one = f.build(device=dev)
    with torch.no_grad():
        tr = tomography.radiance(one, em, torch.tensor([[d_perp, 0.0, -5.0]], device=dev),
                                 torch.tensor([[0.0, 0.0, 1.0]], device=dev),
                                 tomography.TomographyConfig(max_depth=8))
    tau = sigma_t * math.exp(-0.5 * d_perp ** 2 / s ** 2) / (2.0 * math.pi * s * s)
    res["analytic_rel_err"] = abs(float(tr[0, 0]) / math.exp(-tau) - 1.0)
    if not res["analytic_rel_err"] <= 1e-3:
        fail(f"tomography_frame: one Gaussian's transmittance is {res['analytic_rel_err']} "
             "from its closed form")
    phase("tomography_frame", **res)
    details["tomography_frame"] = res
    return res


def tomography_step(dev, details, out=None) -> dict:
    """Phase 27: optimize_volume's step at its defaults (8 cameras at 256^2,
    the 16^3 lattice, 1 spp): the scattering reference at VOLUME_REF_SPP,
    then VOLUME_STEPS steps of render_batch + L1 + backward() +
    BoundedAdam.step through the CLI's own functions. The loss must fall
    and sigma_t stay in [1e-8, 1e-3]. With ``out`` two more steps are
    profiled."""
    from volprim_tpu_torch.examples import optimize_volume as ov
    from volprim_tpu_torch.models import tomography
    from volprim_tpu_torch.ops.envmap import ConstantEmitter
    from volprim_tpu_torch.optim import BoundedAdam
    from volprim_tpu_torch.scene import lattice_init, procedural_smoke

    args = ov.parser().parse_args(["--output", os.path.join(ASSET_DIR, "volume"),
                                   "--ref_spp", str(VOLUME_REF_SPP)])
    cams = ov.ring_cameras(args.cam_count, args.cam_res)
    em = ConstantEmitter(radiance=torch.ones(3, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ov.reference_image(procedural_smoke(device=dev), cams, args, em, dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    prims = lattice_init(args.volprim_count, args.init_sigmat, args.init_albedo, device=dev)
    cfg = tomography.TomographyConfig(max_depth=args.max_depth, kernel_type=args.kernel)
    opt = ov.make_optimizer(args)
    params = ov.volume_params(prims)
    torch.cuda.reset_peak_memory_stats()
    losses, psnrs, times = [], [], []
    for it in range(VOLUME_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, psnr, _ = ov.train_step(params, opt, cams, cfg, em, ref, args, it, prims.extent)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        psnrs.append(psnr)
    peak = torch.cuda.max_memory_allocated()
    sig = params["sigmat"].detach()
    res = dict(ref_spp=VOLUME_REF_SPP, ref_spp_cut_from=32, steps=VOLUME_STEPS,
               steps_cut_from=64, reference_s=ref_s, step_ms=float(np.median(times[1:4])),
               step_ms_all=times, peak_gib=peak / 2**30, tomo_pairs=tomography._TOMO_PAIRS,
               pairs_per_step=args.cam_count * args.cam_res ** 2 * prims.num_prims,
               losses=losses, psnrs=psnrs, sigmat_min=float(sig.min()),
               sigmat_max=float(sig.max()))
    if not losses[-1] < losses[0]:
        fail(f"tomography_step: the loss did not fall over {VOLUME_STEPS} steps: {losses}")
    if not (float(sig.min()) >= np.float32(1e-8) and float(sig.max()) <= np.float32(1e-3)):
        fail(f"tomography_step: sigma_t left [1e-8, 1e-3]: {res['sigmat_min']}, "
             f"{res['sigmat_max']}")
    if out:
        busy_ms, split = device_profile(
            lambda i: ov.train_step(params, opt, cams, cfg, em, ref, args, 100 + i,
                                    prims.extent),
            out, "chip_smoke_tomography_profile.txt",
            stages={tomography: ("_chunk_tau", "_row_sum"), BoundedAdam: ("step",)})
        res.update(device_busy_ms_per_step=busy_ms, device_idle_share=1.0 - busy_ms
                   / res["step_ms"], device_ms_by_stage=split)
    phase("tomography_step", **res)
    details["tomography_step"] = res
    return res


def gridvol_reference(dev, details) -> dict:
    """Phase 28: the scattering reference of optimize_volume at full width
    (procedural_smoke, 48^3; 8 cameras at 256^2; VOLUME_REF_SPP samples, cut
    from 32): its time from phase 27, which rendered it, and the device
    kernels and device ms of one sample; then the furnace: a uniform
    grid at albedo 1 under a unit emitter returns it, mean within 0.03 of 1
    on 4096 rays (tests/test_tomography.py's
    test_gridvol_scattering_furnace)."""
    from torch.profiler import ProfilerActivity, profile

    from volprim_tpu_torch.examples import optimize_volume as ov
    from volprim_tpu_torch.models import gridvol, render_batch
    from volprim_tpu_torch.ops.envmap import ConstantEmitter
    from volprim_tpu_torch.scene import GridVolume, procedural_smoke

    em = ConstantEmitter(radiance=torch.ones(3, device=dev))
    cams = ov.ring_cameras(8, 256)
    grid = procedural_smoke(device=dev)
    ref_s = details["tomography_step"]["reference_s"]
    res = dict(grid=list(grid.resolution), ref_spp=VOLUME_REF_SPP, ref_spp_cut_from=32,
               ms=ref_s * 1e3, ms_per_spp=ref_s * 1e3 / VOLUME_REF_SPP)
    gcfg = gridvol.GridVolumeConfig()
    # grid samples of one spp: every bounce runs its tracking and marching
    # steps in full (no early exit)
    samples = 8 * 256 * 256 * gcfg.bounce_cap * (gcfg.tracking_steps + gcfg.shadow_steps)
    res.update(samples_1spp=samples, bound_ms_1spp=samples * OPS_GRID_SAMPLE / PEAK_F32 * 1e3)
    # the kernels of one sample: profiles at bounce caps 1 and 2 (the host's
    # rows left out: ~10^6 ops a sample cost minutes to record), whose
    # difference is one bounce; every bounce launches the same kernels on
    # the same shapes (no early exit), so a sample at the cap launches
    # n(1) + (cap - 1) (n(2) - n(1))
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    counts, dev_ms = [], []
    t0 = time.perf_counter()
    for cap in (1, 2):
        pcfg = dataclasses.replace(gcfg, bounce_cap=cap)
        with profile(activities=acts) as prof, torch.no_grad():
            img = render_batch(gridvol.transform_grid(grid, pcfg), cams,
                                  gridvol.radiance_scattering, pcfg, em, spp=1,
                                  generator=_generator(dev, 0))
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(int(sum(e.count for e in rows)))
        dev_ms.append(sum(e.self_device_time_total for e in rows) / 1e3)
    cap = gcfg.bounce_cap
    res.update(launches_cap1_cap2=counts, device_ms_cap1_cap2=dev_ms,
               launches_1spp=counts[0] + (cap - 1) * (counts[1] - counts[0]),
               device_ms_1spp=dev_ms[0] + (cap - 1) * (dev_ms[1] - dev_ms[0]),
               profiled_s=time.perf_counter() - t0)
    res["device_idle_share"] = 1.0 - res["device_ms_1spp"] / res["ms_per_spp"]
    if not bool(torch.isfinite(img).all()):
        fail("gridvol_reference: the two-bounce reference is not finite")
    # the furnace
    flat = GridVolume(torch.full((8, 8, 8, 1), 0.8, device=dev),
                      torch.full((3,), -1.0, device=dev), torch.full((3,), 1.0, device=dev))
    fcfg = gridvol.GridVolumeConfig(sigma_scale=3.0, albedo=1.0, bounce_cap=64,
                                    tracking_steps=64, shadow_steps=64)
    n = 4096
    o = torch.tensor([[0.0, 0.0, -3.0]], device=dev).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(n, 1)
    with torch.no_grad():
        fl = gridvol.radiance_scattering(flat, em, o, d, fcfg, _generator(dev, 0))
    res["furnace_mean"] = float(fl[:, 0].mean())
    if not bool(torch.isfinite(fl).all()) or abs(res["furnace_mean"] - 1.0) >= 0.03:
        fail(f"gridvol_reference: the furnace's mean is {res['furnace_mean']}")
    phase("gridvol_reference", **res)
    details["gridvol_reference"] = res
    return res


def volume_clis(dev, details) -> dict:
    """Phase 29: optimize_volume at full widths (--cam_count 8 --cam_res 256
    --volprim_count 16; --iterations 8 and --ref_spp 4, cut from 64 / 32) in
    a subprocess, its PSNR must rise; then render_asset on the asset it
    wrote, and on the same scene written by save_reference_asset: finite
    images in [0, 1]; each wall time."""
    from volprim_tpu_torch.ops.envmap import ConstantEmitter
    from volprim_tpu_torch.scene import asset_interop, load_asset
    from volprim_tpu_torch.utils.image import read_exr

    out = os.path.join(ASSET_DIR, "volume_cli")
    res = {}
    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    wall, stdout = _run_cli("optimize_volume", [
        "--output", out, "--cam_count", "8", "--cam_res", "256", "--volprim_count", "16",
        "--iterations", str(VOLUME_STEPS), "--ref_spp", str(VOLUME_REF_SPP)])
    psnrs = [float(m) for m in re.findall(r"\| psnr=([0-9.eE+-]+)", stdout)]
    with open(os.path.join(out, "curves.json")) as f:
        curves = json.load(f)
    res["optimize_volume"] = dict(wall_s=wall, psnrs=psnrs, losses=curves["loss"],
                                  iterations_cut_from=64, ref_spp_cut_from=32)
    if len(psnrs) != VOLUME_STEPS or not psnrs[-1] > psnrs[0]:
        fail(f"volume_clis: optimize_volume's PSNR did not rise: {psnrs}")
    asset_dir = os.path.join(out, "optimized_asset")
    asset = load_asset(asset_dir, device=dev)
    ref_dir = os.path.join(out, "reference_asset")
    asset_interop.save_reference_asset(ref_dir, asset["primitives"], asset["cameras"],
                                       ConstantEmitter(radiance=torch.ones(3, device=dev)))
    imgs = {}
    for name, src in (("render_asset", asset_dir), ("render_asset_reference", ref_dir)):
        exr = os.path.join(out, f"{name}.exr")
        wall, _ = _run_cli("render_asset", [src, "--output", exr, "--spp", "4"])
        img = read_exr(exr)
        imgs[name] = img
        res[name] = dict(wall_s=wall, shape=list(img.shape), mean=float(img.mean()))
        cam = asset["cameras"][0]
        if (img.shape != (cam.height, cam.width, 3) or not np.isfinite(img).all()
                or img.min() < 0.0
                or img.max() > 1.0 + 1e-6):
            fail(f"volume_clis: {name}'s image is {img.shape}, not finite or outside [0, 1]")
    res["formats_max_abs_diff"] = float(np.abs(imgs["render_asset"]
                                               - imgs["render_asset_reference"]).max())
    phase("volume_clis", **res)
    details["volume_clis"] = res
    return res


# ---- the rest of the path tracer (phases 30-33) -----------------------------

PRB_SEQ_CHUNK = 65536  # rays per free_flight call in phase 30 (prb's ray_chunk)
XLA_SEQ_WIDTH = 256  # phase 31's film for the xla walk's sequential paths
# render_volume's --spp and film in phase 33 (the spp cut from the CLI's 64)
RV_SPP, RV_WIDTH = 4, 512


def frame_stats(img) -> dict:
    """Per-channel mean of a 1-spp frame and its standard error over the
    pixels (each pixel one path: the scene's variation counts as noise)."""
    x = img.reshape(-1, 3).double()
    return dict(mean=x.mean(0), se=x.std(0) / math.sqrt(x.shape[0]))


def means_agree(a: dict, b: dict) -> tuple:
    """(whether each channel's means lie within 4 standard errors of their
    difference, the largest |difference| / standard error)."""
    se = torch.sqrt(a["se"] ** 2 + b["se"] ** 2)
    z = torch.abs(a["mean"] - b["mean"]) / torch.clamp(se, min=1e-30)
    return bool((z <= 4.0).all()), float(z.max())


def recording_walks(ffwalk, fn):
    """fn() with every launch of the walk kernel recorded, its count set to
    0 just before and read just after. Returns (fn's result, launches,
    [(args, kwargs)] of each launch)."""
    launch = ffwalk._launch
    rec = []

    def hook(*a, **k):
        rec.append((a, k))
        return launch(*a, **k)

    ffwalk._launch = hook
    ffwalk.walk.launches = 0
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        n = ffwalk.walk.launches
        ffwalk._launch = launch
    return out, n, rec


def replay_walks(ffwalk, rec, name: str) -> list:
    """Every recorded walk launch replayed through ffwalk.walk against the
    plain version on its own inputs (compare_walk), its kernel time
    (launch_ms) and the work its inputs need (walk_work); the plain
    version's time on the path's largest launch only (one run of it costs
    ~0.1-0.3 s at 65,536 rays)."""
    rows = []
    largest = max(range(len(rec)), key=lambda i: rec[i][0][0].shape[0]) if rec else -1
    for i, (a, k) in enumerate(rec):
        n0 = ffwalk.walk.launches
        got = ffwalk.walk(*a, **k)
        wk = {}
        want = ffwalk.walk_reference(*a, **k, work=wk)
        torch.cuda.synchronize()
        if ffwalk.walk.launches != n0 + 1:
            fail(f"{name}: ffwalk.walk did not launch its kernel once on a replayed launch")
        row = dict(rays=int(a[0].shape[0]), kp=int(a[0].shape[1]),
                   finite_caps=int(torch.isfinite(a[7]).sum()),
                   finite_budgets=int(torch.isfinite(a[6]).sum()),
                   started_past_0=int((a[9] > 0).sum()),
                   **compare_walk(got, want, int(a[8].sum())),
                   ms=launch_ms(lambda: ffwalk._launch(*a, **k), 3),
                   plain_ms=(cuda_ms(lambda: ffwalk.walk_reference(*a, **k), 1, warmup=0)
                             if i == largest else None),
                   **walk_work(a, k, wk))
        rows.append(row)
    bad = [r_ for r_ in rows if not r_["ok"]]
    if bad:
        fail(f"{name}: the walk kernel disagrees with its plain version on {len(bad)} of "
             f"{len(rows)} launches")
    return rows


def walk_totals(rows) -> dict:
    """A path's walk launches summed: kernel ms, bound, bytes, rays; the
    plain version's ms on its largest launch against the kernel's there."""
    big = [r_ for r_ in rows if r_["plain_ms"] is not None]
    bound = sum(r_["bound_ms"] for r_ in rows)
    bound_bytes = sum(r_["bound_ms"] for r_ in rows if r_["bound_by"] == "bytes")
    return dict(
        launches=len(rows), ms=sum(r_["ms"] for r_ in rows), bound_ms=bound,
        bound_by="bytes" if bound_bytes >= bound / 2 else "operations",
        bytes=sum(r_["bytes"] for r_ in rows), rays=sum(r_["rays"] for r_ in rows),
        rays_differ=sum(r_["decisions_differ"] + r_["t_outside_tol"] for r_ in rows),
        max_abs_dt=max([r_["max_abs_dt"] for r_ in rows] + [0.0]),
        finite_caps=sum(r_["finite_caps"] for r_ in rows),
        started_past_0=sum(r_["started_past_0"] for r_ in rows),
        windows=sum(r_["work"].get("windows", 0) for r_ in rows),
        largest_launch_ms=big[0]["ms"] if big else None,
        largest_launch_plain_ms=big[0]["plain_ms"] if big else None,
    )


def prb_xla_frame(medium, pcam, po, pd, sky, jump_stats, dev, details) -> dict:
    """Phase 30: phase 10's frame through walk_backend="xla": a warm-up and
    3 timed frames (median), peak memory, the mean radiance within 4
    standard errors of phase 10's pallas frame; then bounce 0 per ray:
    free_flight on the 262,144 camera rays with one xi under both backends,
    in PRB_SEQ_CHUNK-ray calls, the rays whose found / dead differ or whose
    t_samp differ by more than WALK_ATOL + WALK_RTOL |t| at most
    WALK_DIFF_SHARE of them."""
    from volprim_tpu_torch.models import prb, render

    cfg = prb.PRBConfig(walk_backend="xla")
    seeds = iter(range(800, 900))

    def frame():
        return render(medium, pcam, prb.radiance, cfg, sky, 1,
                      torch.Generator(device=dev).manual_seed(next(seeds)))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    img = frame()
    times = cuda_times(frame, 3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(img).all()):
        fail("prb_xla_frame: the xla frame is not finite")
    st = frame_stats(img)
    agree, z = means_agree(st, jump_stats)
    # bounce 0, per ray
    xi = 1e-7 + (1.0 - 1e-7) * torch.rand(po.shape[0], generator=torch.Generator(
        device=dev).manual_seed(30), device=dev)
    outs = {}
    for backend in ("xla", "pallas"):
        c = prb.PRBConfig(walk_backend=backend)
        parts = [prb.free_flight(medium, po[s:s + PRB_SEQ_CHUNK], pd[s:s + PRB_SEQ_CHUNK],
                                 xi[s:s + PRB_SEQ_CHUNK], c,
                                 torch.ones_like(xi[s:s + PRB_SEQ_CHUNK], dtype=torch.bool))
                 for s in range(0, po.shape[0], PRB_SEQ_CHUNK)]
        outs[backend] = [torch.cat([p_[i] for p_ in parts]) for i in range(3)]
    fx, fp = outs["xla"], outs["pallas"]
    differ = (fx[0] != fp[0]) | (fx[1] != fp[1])
    both = fx[0] & fp[0]
    dt = torch.abs(fx[2] - fp[2])[both]
    outside = dt > WALK_ATOL + WALK_RTOL * torch.abs(fp[2][both])
    n_bad = int(differ.sum()) + int(outside.sum())
    res = dict(frame_ms=float(np.median(times)), frame_ms_min=times[0],
               frame_ms_max=times[-1], peak_mem_gib=peak,
               mean_radiance=[float(x) for x in st["mean"]],
               jump_frame_mean=[float(x) for x in jump_stats["mean"]], max_z=z,
               bounce0_rays=int(po.shape[0]), bounce0_found=int(fp[0].sum()),
               bounce0_dead=int(fp[1].sum()), bounce0_rays_differ=n_bad,
               bounce0_max_abs_dt=float(dt.max()) if dt.numel() else 0.0)
    phase("prb_xla_frame", **res)
    details["prb_xla_frame"] = dict(res, times=times)
    if not agree:
        fail(f"prb_xla_frame: mean radiance {res['mean_radiance']} vs the pallas frame's "
             f"{res['jump_frame_mean']} ({z:.2f} standard errors)")
    if n_bad > WALK_DIFF_SHARE * po.shape[0]:
        fail(f"prb_xla_frame: bounce 0's walks differ between the backends on {n_bad} rays")
    return res


def bounce0_flights(prb, medium, po, pd, xi, cfg) -> list:
    """free_flight's (found, dead, t_samp) on the camera rays, in
    PRB_SEQ_CHUNK-ray calls."""
    parts = [prb.free_flight(medium, po[s:s + PRB_SEQ_CHUNK], pd[s:s + PRB_SEQ_CHUNK],
                             xi[s:s + PRB_SEQ_CHUNK], cfg,
                             torch.ones_like(xi[s:s + PRB_SEQ_CHUNK], dtype=torch.bool))
             for s in range(0, po.shape[0], PRB_SEQ_CHUNK)]
    return [torch.cat([p_[i] for p_ in parts]) for i in range(3)]


def flights_differ(a, b) -> tuple:
    """Rays whose found / dead differ between two bounce0_flights, or whose
    t_samp differ by more than WALK_ATOL + WALK_RTOL |t|; the largest
    |dt| of the rays found by both."""
    differ = (a[0] != b[0]) | (a[1] != b[1])
    both = a[0] & b[0]
    dt = torch.abs(a[2] - b[2])[both]
    outside = dt > WALK_ATOL + WALK_RTOL * torch.abs(b[2][both])
    return int(differ.sum()) + int(outside.sum()), float(dt.max()) if dt.numel() else 0.0


# Phase 31's pairs of paths whose walks kill the same rays: their frames are
# the same estimator, held to each other within 4 standard errors, and,
# where the flag is set, per ray at bounce 0. The jump path (4 windows from
# the jump block), the sequential fused walk (max_windows from t = 0) and
# the xla walk's re-collection rounds kill different rays where more than
# k intervals overlap (the plume's core): their means differ by more than
# the noise of a 512^2 frame, and are recorded beside their bounce-0 dead
# shares. A re-collection round clamps every straddling entry to its
# start, and the tie goes to the lower primitive id, in Morton order with
# clusters and in scene order without: where more than k straddle, the
# two keep different intervals, so the xla pair agrees in mean only.
TWIN_PATHS = (("coeff_gemm_pallas", "jump_pallas", True),
              ("clusters_pallas", "sequential_pallas", True),
              ("clusters_xla", "sequential_xla", False))


def prb_walk_paths(ffwalk, medium, pcam, po, pd, sky, dev, details) -> dict:
    """Phase 31: first count_intervals on the camera rays and
    suggest_budgets' config (prb_budgets). Then the plume frame under that
    config on the jump path (pallas), through the sequential walk
    (jump=False) and through cluster collection (use_clusters), each under
    both backends, through coeff_gemm (pallas) and with the Epanechnikov
    kernel (xla). Every walk launch of the pallas runs is recorded (the
    count set to 0 just before the frame) and replayed against the plain
    version; each path's launches and walk_work are printed. Each frame:
    the counted run, then 2 timed (the xla paths: XLA_SEQ_WIDTH^2, the
    counted run alone); its mean, its bounce-0 found and dead shares
    (free_flight on its camera rays with one xi) and its standard errors
    from the jump frame's mean. TWIN_PATHS are held to each other:
    means within 4 standard errors, bounce-0 decisions per ray where
    flagged."""
    from volprim_tpu_torch.models import prb, render
    from volprim_tpu_torch.scene import generate_rays, synthetic

    need = torch.cat([prb.count_intervals(medium, po[s:s + PRB_SEQ_CHUNK],
                                          pd[s:s + PRB_SEQ_CHUNK], 1024)
                      for s in range(0, po.shape[0], PRB_SEQ_CHUNK)]).cpu().numpy()
    sug = prb.suggest_budgets(medium, po, pd, prb.PRBConfig())
    res = {"budgets": dict(
        need_p50=float(np.percentile(need, 50)), need_p99=float(np.percentile(need, 99)),
        need_p999=float(np.percentile(need, 99.9)), need_max=int(need.max()),
        collect_budget=sug.collect_budget, max_windows=sug.max_windows)}
    phase("prb_budgets", **res["budgets"])
    if not (sug.collect_budget % 16 == 0 and sug.max_windows * sug.max_overlaps
            >= sug.collect_budget and sug.collect_budget <= ffwalk.MAX_KP):
        fail(f"prb_walk_paths: suggest_budgets gave {res['budgets']}")

    # the xla walk's sequential paths take 49-63 s a 512^2 frame on an H100
    # 80GB HBM3 at 700 W (scripts/prb_phases.py --xla_seq_width 512; eager
    # window loops on every live ray, re-collection rounds): they render at
    # XLA_SEQ_WIDTH^2, once, and their twin is held at that film
    paths = {
        "jump_pallas": dict(walk_backend="pallas"),
        "sequential_xla": dict(jump=False, walk_backend="xla"),
        "sequential_pallas": dict(jump=False, walk_backend="pallas"),
        "clusters_xla": dict(use_clusters=True, walk_backend="xla"),
        "clusters_pallas": dict(use_clusters=True, walk_backend="pallas"),
        "coeff_gemm_pallas": dict(coeff_gemm=True, walk_backend="pallas"),
        "epanechnikov_xla": dict(kernel_type="epanechnikov", walk_backend="xla"),
    }
    small_cam = synthetic.medium_camera(XLA_SEQ_WIDTH, XLA_SEQ_WIDTH)
    so, sd = generate_rays(small_cam, jitter=False, device=dev)
    walk_rows, stats, flights = {}, {}, {}
    for i, (name, kw) in enumerate(paths.items()):
        cfg = dataclasses.replace(sug, **kw)
        slow = kw["walk_backend"] == "xla"
        cam, ro, rd = (small_cam, so, sd) if slow else (pcam, po, pd)
        seeds = iter(range(1000 + 100 * i, 1100 + 100 * i))

        def frame():
            return render(medium, cam, prb.radiance, cfg, sky, 1,
                          torch.Generator(device=dev).manual_seed(next(seeds)))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img, n_launch, rec = recording_walks(ffwalk, frame)
        counted_s = time.perf_counter() - t0
        times = [counted_s * 1e3] if slow else cuda_times(frame, 2, warmup=0)
        row = dict(width=cam.width, frame_ms=float(np.median(times)), frame_ms_min=times[0],
                   counted_frame_s=round(counted_s, 2),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=n_launch)
        if not bool(torch.isfinite(img).all()):
            fail(f"prb_walk_paths: the {name} frame is not finite")
        stats[name] = frame_stats(img)
        row["mean_radiance"] = [float(x) for x in stats[name]["mean"]]
        row["z_vs_jump_frame"] = means_agree(stats[name], stats["jump_pallas"])[1]
        xi = 1e-7 + (1.0 - 1e-7) * torch.rand(ro.shape[0], generator=torch.Generator(
            device=dev).manual_seed(31), device=dev)
        if kw["walk_backend"] == "pallas":
            if n_launch == 0 or n_launch != len(rec):
                fail(f"prb_walk_paths: {name} launched the walk {n_launch} times "
                     f"({len(rec)} recorded)")
            rows = replay_walks(ffwalk, rec, f"prb_walk_paths {name}")
            walk_rows[name] = rows
            row["walk"] = walk_totals(rows)
        elif n_launch:
            fail(f"prb_walk_paths: the xla walk launched the walk kernel ({name})")
        del rec
        flights[name] = bounce0_flights(prb, medium, ro, rd, xi, cfg)
        row["bounce0_found_share"] = float(flights[name][0].float().mean())
        row["bounce0_dead_share"] = float(flights[name][1].float().mean())
        res[name] = row
        phase("prb_walk_path", path=name, **row)
    twins = {}
    for a_, b_, per_ray in TWIN_PATHS:
        agree, z = means_agree(stats[a_], stats[b_])
        n_bad, dt = flights_differ(flights[a_], flights[b_])
        twins[f"{a_}~{b_}"] = dict(max_z=z, bounce0_rays_differ=n_bad, bounce0_max_abs_dt=dt)
        if not agree or (per_ray and n_bad > WALK_DIFF_SHARE * flights[a_][0].shape[0]):
            fail(f"prb_walk_paths: {a_} and {b_} differ: {twins[f'{a_}~{b_}']}")
    res["twins"] = twins
    phase("prb_walk_twins", **twins)
    details["prb_walk_paths"] = dict(res, walk_launches=walk_rows)
    return res


def box_mesh(dev):
    """Phase 32's Cornell box around the plume: size 1.5, Principled walls
    (roughness 0.5, metallic 0.2), its left wall (between the camera and
    the plume) left out."""
    from volprim_tpu_torch.scene import mesh

    attrs = {"base_color": [0.73, 0.73, 0.73], "roughness": [0.5], "metallic": [0.2]}
    walls = {w: dict(attrs) for w in ("floor", "ceiling", "back")}
    walls["right"] = {**attrs, "base_color": [0.12, 0.45, 0.15]}
    return mesh.cornell_box(1.5, walls, device=dev)


def prb_surfaces(ffwalk, medium, pcam, sky, dev, details) -> dict:
    """Phase 32: the plume inside box_mesh() with Principled walls, 512^2,
    1 spp, through the pallas walk: its walk launches (finite surface caps
    t_cap) recorded and replayed against the plain version, the frame's
    time; then the white furnace: a 512-primitive plume made inert (sigma_t
    0) over a white diffuse floor under a unit sky, whose mean radiance
    must lie within 4 standard errors of 1 (every path returns 1 in
    expectation)."""
    from volprim_tpu_torch.models import prb, render
    from volprim_tpu_torch.ops import bsdf, envmap
    from volprim_tpu_torch.scene import mesh, synthetic

    box = box_mesh(dev)
    cfg = prb.PRBConfig(walk_backend="pallas")
    seeds = iter(range(3200, 3300))

    def frame():
        return render(medium, pcam,
                      lambda *a: prb.radiance(*a, mesh=box, bsdf=bsdf.Principled()),
                      cfg, sky, 1, torch.Generator(device=dev).manual_seed(next(seeds)))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    img, n_launch, rec = recording_walks(ffwalk, frame)
    times = cuda_times(frame, 2, warmup=0)
    if not bool(torch.isfinite(img).all()):
        fail("prb_surfaces: the frame is not finite")
    if n_launch == 0 or n_launch != len(rec):
        fail(f"prb_surfaces: the walk launched {n_launch} times ({len(rec)} recorded)")
    rows = replay_walks(ffwalk, rec, "prb_surfaces")
    del rec
    walk = walk_totals(rows)
    if walk["finite_caps"] == 0:
        fail("prb_surfaces: no walk launch had a finite surface cap")
    res = dict(frame_ms=float(np.median(times)), frame_ms_min=times[0],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               faces=box.num_faces, launches=n_launch,
               mean_radiance=[float(x) for x in img.reshape(-1, 3).mean(0)], walk=walk)
    # the white furnace, on a plume of 512 primitives: in the 4096-primitive
    # one more than k intervals overlap, and a ray the walk kills on its way
    # through the (inert) medium returns 0, not 1
    thin = synthetic.make_medium(512, seed=0, device=dev)
    inert = dataclasses.replace(thin, attrs={**thin.attrs,
                                             "sigma_t": thin.attrs["sigma_t"] * 0.0})
    floor = mesh.make_rect([0, -0.6, 0], [50, 0, 0], [0, 0, -50], {"base_color": [1.0] * 3},
                           device=dev)
    unit = envmap.ConstantEmitter(radiance=torch.ones(3, device=dev))
    fcfg = prb.PRBConfig(walk_backend="pallas", bounce_cap=24)
    fimg, f_launch, f_rec = recording_walks(ffwalk, lambda: render(
        inert, pcam, lambda *a: prb.radiance(*a, mesh=floor, bsdf=bsdf.Diffuse()), fcfg, unit,
        1, torch.Generator(device=dev).manual_seed(32)))
    f_rows = replay_walks(ffwalk, f_rec, "prb_surfaces furnace")
    del f_rec
    st = frame_stats(fimg)
    z = float(torch.max(torch.abs(st["mean"] - 1.0) / torch.clamp(st["se"], min=1e-30)))
    res["furnace"] = dict(mean_radiance=[float(x) for x in st["mean"]],
                          se=[float(x) for x in st["se"]], max_z=z, launches=f_launch,
                          walk=walk_totals(f_rows))
    phase("prb_surfaces", **res)
    details["prb_surfaces"] = dict(res, times=times, walk_launches=rows)
    if not (bool(torch.isfinite(fimg).all()) and z <= 4.0):
        fail(f"prb_surfaces: the furnace's mean {res['furnace']['mean_radiance']} is {z:.2f} "
             "standard errors from 1")
    return res


def render_volume_cli(details) -> dict:
    """Phase 33: the render_volume CLI in a subprocess at RV_WIDTH^2 and
    RV_SPP spp (cut from 64), once with --walk_backend xla --auto_budget and once
    with --walk_backend pallas: finite EXRs, their means within 4 standard
    errors of each other, each wall time."""
    from volprim_tpu_torch.utils.image import read_exr

    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    os.makedirs(ASSET_DIR, exist_ok=True)
    res, stats = {}, {}
    for name, extra in (("xla_auto_budget", ["--walk_backend", "xla", "--auto_budget"]),
                        ("pallas", ["--walk_backend", "pallas"])):
        exr = os.path.join(ASSET_DIR, f"render_volume_{name}.exr")
        wall, stdout = _run_cli("render_volume", [
            "--output", exr, "--spp", str(RV_SPP), "--width", str(RV_WIDTH), "--height",
            str(RV_WIDTH), *extra])
        img = read_exr(exr)
        if img.shape != (RV_WIDTH, RV_WIDTH, 3) or not np.isfinite(img).all():
            fail(f"render_volume_cli: {name}'s image is {img.shape} or not finite")
        x = torch.from_numpy(img).reshape(-1, 3).double()
        # RV_SPP samples a pixel: the pixel values' spread over their count
        stats[name] = dict(mean=x.mean(0), se=x.std(0) / math.sqrt(x.shape[0]))
        m = re.search(r"Rendering: ([0-9.]+) ms", stdout)
        budget = re.search(r"collect_budget=(\d+) max_windows=(\d+)", stdout)
        res[name] = dict(wall_s=wall, render_ms=float(m.group(1)) if m else None,
                         mean=[float(v) for v in stats[name]["mean"]],
                         auto_budget=[int(budget.group(1)), int(budget.group(2))]
                         if budget else None)
    agree, z = means_agree(stats["xla_auto_budget"], stats["pallas"])
    res.update(max_z=z, spp=RV_SPP, spp_cut_from=64)
    phase("render_volume_cli", **res)
    details["render_volume_cli"] = res
    if not agree:
        fail(f"render_volume_cli: the two images' means are {z:.2f} standard errors apart")
    return res


# phase 34: fit_radiosity_bsdf's iterations (cut from 60) and the steps
# timed among them
RAD_ITERS, RAD_TIMED = 30, 5
# phase 36: generate_dataset's icosphere subdivisions (12 cameras; 42 at
# the default 1) and spp (cut from 8)
DS_SUBDIV, DS_SPP = 0, 1


def radiosity_fit(ffwalk, dev, details, out=None) -> dict:
    """Phase 34: fit_radiosity_bsdf's setup and step for each BSDF at the
    CLI's defaults, RAD_ITERS iterations; then one compute_loss's cache
    queries under walk_backend="pallas", their walk launches replayed
    against the plain version and li_w's mean held to the xla walk's.
    Returns the diffuse fit's cache and mesh (phase 35) and the walk's
    totals."""
    from volprim_tpu_torch.examples import fit_radiosity_bsdf as fit_cli
    from volprim_tpu_torch.scene import mesh as mesh_mod
    from volprim_tpu_torch.utils import benchmark

    res = {}
    kept = None
    for name in ("diffuse", "principled"):
        args = fit_cli.parser().parse_args(["--bsdf", name, "--iterations", str(RAD_ITERS)])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, mesh_gt, cache, attrs, opt = fit_cli.setup(args, dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        mae0 = fit_cli.base_color_mae(attrs, mesh_gt)
        losses = []

        def step():
            losses.append(fit_cli.step(cache, mesh_gt, model, attrs, opt, gen, args))

        t0 = time.perf_counter()
        bench = benchmark.measure(step, label=f"radiosity {name}", nb_runs=RAD_TIMED,
                                  nb_dry_runs=0, log=False)
        while len(losses) < RAD_ITERS:
            step()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        loss = torch.stack(losses).cpu()
        mae = fit_cli.base_color_mae(attrs, mesh_gt)
        row = dict(iterations=len(losses), iterations_cut_from=60, first_step_ms=bench.compile_ms,
                   step_ms=float(np.median(bench.runs)), step_ms_runs=bench.runs,
                   fit_s=fit_s, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   loss_first=float(loss[0]), loss_last=float(loss[-1]),
                   mae_initial=mae0, mae_final=mae, vertices=mesh_gt.num_vertices,
                   rays_per_step=args.num_points * (args.num_wi + args.num_wo))
        if out:
            busy_ms = device_profile(lambda i: step(), out, f"chip_smoke_radiosity_{name}.txt")
            row.update(device_busy_ms_per_step=busy_ms,
                       device_idle_share=1.0 - busy_ms / row["step_ms"])
        phase("radiosity_fit", bsdf=name, **row)
        res[name] = row
        if not bool(torch.isfinite(loss).all()):
            fail(f"radiosity_fit {name}: a loss is not finite")
        if not mae < mae0:
            fail(f"radiosity_fit {name}: the base_color MAE went {mae0:.4f} -> {mae:.4f}")
        if name == "diffuse":
            kept = (cache, mesh_gt, args)

    # one compute_loss's cache queries through the walk kernel
    cache, mesh_gt, args = kept
    pallas = dataclasses.replace(cache, cfg=dataclasses.replace(cache.cfg,
                                                                walk_backend="pallas"))
    with torch.no_grad():
        pts, nrm, *_ = mesh_mod.sample_surface(
            mesh_gt, torch.Generator(device=dev).manual_seed(3400), args.num_points)

    def queries(c, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        li_w, _ = c.eval_li_mat(pts, nrm, g, args.num_wi)
        u = torch.rand((args.num_points, 2), generator=g, device=dev)
        r, phi = torch.sqrt(u[:, 0]), 2.0 * math.pi * u[:, 1]
        wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                          torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))], dim=-1)
        return li_w, c.eval_lo(pts, nrm, wo, g)

    (li_p, lo_p), n_launch, rec = recording_walks(ffwalk, lambda: queries(pallas, 3401))
    li_x, lo_x = queries(cache, 3402)
    if n_launch == 0 or n_launch != len(rec):
        fail(f"radiosity_fit: the walk launched {n_launch} times ({len(rec)} recorded)")
    rows = replay_walks(ffwalk, rec, "radiosity_fit walk")
    del rec
    walk = walk_totals(rows)
    stats = {k: frame_stats(v) for k, v in (("pallas", li_p), ("xla", li_x))}
    agree, z = means_agree(stats["pallas"], stats["xla"])
    res["pallas_queries"] = dict(
        rays=int(li_p.shape[0] * li_p.shape[1] + lo_p.shape[0]), launches=n_launch,
        li_w_mean={k: [float(x) for x in v["mean"]] for k, v in stats.items()}, max_z=z,
        walk=walk)
    phase("radiosity_walk", **res["pallas_queries"])
    details["radiosity_fit"] = dict(res, walk_launches=rows)
    finite = all(bool(torch.isfinite(x).all()) for x in (li_p, lo_p, li_x, lo_x))
    if not finite or walk["rays_differ"] or walk["finite_caps"] == 0:
        fail(f"radiosity_fit: pallas queries finite {finite}, {walk['rays_differ']} rays "
             f"differ from the plain walk, {walk['finite_caps']} finite caps")
    if not agree:
        fail(f"radiosity_fit: li_w's means under the two walks are {z:.2f} standard errors "
             "apart")
    return dict(res, cache=cache, mesh=mesh_gt, walk=walk)


def sh_fit_visualizer(cache, mesh_gt, dev, details) -> dict:
    """Phase 35: fit_sh_on_mesh at its defaults on phase 34's diffuse
    scene, held to direct queries at vertex 0; render_mesh_attribute of
    base_color at 512^2."""
    from volprim_tpu_torch.ops import bsdf, sh
    from volprim_tpu_torch.scene import CameraSpecs, look_at
    from volprim_tpu_torch.tooling import sh_fit, visualizer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coeffs = sh_fit.fit_sh_on_mesh(cache, mesh_gt, generator=torch.Generator(
        device=dev).manual_seed(3500))
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    m = sh_fit.spherical_quadrature(15, dev)[0].shape[0]
    rng = np.random.default_rng(0)
    dl = rng.normal(size=(8, 3))
    dl[:, 2] = np.abs(dl[:, 2]) + 1.0  # well inside the hemisphere
    dl = torch.from_numpy((dl / np.linalg.norm(dl, axis=-1, keepdims=True))
                          .astype(np.float32)).to(dev)
    recon = sh.eval_basis(dl, 3) @ coeffs[0]
    v0, n0 = mesh_gt.vertices[0], mesh_gt.vertex_normals()[0]
    dw = bsdf.to_world(n0.expand(8, 3), dl)
    direct = cache.query((v0 + n0 * 1e-3)[None, :] + dw * 1e-3, -dw,
                         torch.Generator(device=dev).manual_seed(3501))
    err = float((recon - direct).abs().mean())

    cam = CameraSpecs("vis", 512, 512, look_at([0.0, 2.5, -5.5], [0.0, 0.5, 0.0], [0, 1, 0]),
                      fov=45.0)
    vis_ms = []
    for _ in range(2):  # the first call and a second one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = visualizer.render_mesh_attribute(mesh_gt, cam, "base_color")
        vis_ms.append((time.perf_counter() - t0) * 1e3)
    res = dict(vertices=mesh_gt.num_vertices, directions=m, rays=mesh_gt.num_vertices * m,
               fit_ms=fit_ms, coeffs_finite=bool(torch.isfinite(coeffs).all()),
               self_consistency_mae=err, limit=0.15, visualizer_ms=vis_ms,
               visualizer_hit_share=float((img.min(-1) < 0.99).mean()),
               corner=[float(x) for x in img[0, 0]])
    phase("sh_fit_visualizer", **res)
    details["sh_fit_visualizer"] = res
    if not (res["coeffs_finite"] and err < 0.15):
        fail(f"sh_fit_visualizer: coefficients finite {res['coeffs_finite']}, the "
             f"reconstruction {err:.4f} from direct queries (limit 0.15)")
    if not (np.isfinite(img).all() and img[0, 0].min() >= 0.99 and res["visualizer_hit_share"]):
        fail("sh_fit_visualizer: the attribute view is not finite, or its corner is not the "
             "white background, or it shows no mesh")
    return res


def generate_dataset_cli(ply, exact_s, dev, details) -> dict:
    """Phase 36: the generate_dataset CLI in a subprocess on phase 21's
    PLY at 256^2 with --subdivisions DS_SUBDIV and --spp DS_SPP; its
    layout, images and transforms checked."""
    import shutil

    from volprim_tpu_torch.scene import load_ply
    from volprim_tpu_torch.tooling import dataset

    out = os.path.join(ASSET_DIR, "dataset")
    shutil.rmtree(out, ignore_errors=True)
    n_cams = len(dataset.icosphere(DS_SUBDIV))
    # the size of the cut, from phase 5's exact-order render of 4,096 pixels
    # at max_depth 128 (the CLI's is 64): a camera is 65,536 pixels a sample
    predicted_s = exact_s * 65536 / 4096 * DS_SPP * n_cams
    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    wall, stdout = _run_cli("generate_dataset", [
        "--ply", ply, "--output", out, "--resolution", "256", "--subdivisions", str(DS_SUBDIV),
        "--spp", str(DS_SPP), "--points", "100000"], timeout=900)
    cam_ms = [float(x) for x in re.findall(r"Rendering r_\d+: ([0-9.]+) ms", stdout)]
    center = load_ply(ply, device=dev).centers.mean(dim=0).cpu().numpy().astype(np.float64)
    rig = dataset.icosphere_rig(center, 4.0, width=256, height=256, fov=45.0,
                                subdivisions=DS_SUBDIV)
    n_test = max(1, int(len(rig) * 0.15))
    splits = {"train": rig[n_test:], "test": rig[:n_test]}
    problems = []
    transforms_err = 0.0
    for split, cams in splits.items():
        with open(os.path.join(out, f"transforms_{split}.json")) as f:
            got = json.load(f)
        want = dataset.transforms_dict(cams)
        if len(got["frames"]) != len(cams) or got["camera_angle_x"] != want["camera_angle_x"]:
            problems.append(f"transforms_{split}.json has {len(got['frames'])} frames")
            continue
        for a, b in zip(got["frames"], want["frames"]):
            if a["file_path"] != b["file_path"]:
                problems.append(f"{split}: frame {a['file_path']} for {b['file_path']}")
            transforms_err = max(transforms_err, float(np.abs(
                np.asarray(a["transform_matrix"]) - np.asarray(b["transform_matrix"])).max()))
    img_min, img_mean = [], []
    for cam in rig:
        for ext in ("png", "npy"):
            if not os.path.exists(os.path.join(out, "images", f"{cam.name}.{ext}")):
                problems.append(f"images/{cam.name}.{ext} is missing")
        img = np.load(os.path.join(out, "images", f"{cam.name}.npy"))
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            problems.append(f"images/{cam.name}.npy is {img.shape} or not finite")
        img_min.append(float(img.min()))
        img_mean.append(float(img.mean()))
    pc = np.load(os.path.join(out, "points3d.npz"))
    if pc["points"].shape != (100000, 3) or pc["colors"].shape != (100000, 3):
        problems.append(f"points3d.npz holds {pc['points'].shape} points")
    res = dict(cameras=n_cams, cameras_cut_from=42, spp=DS_SPP, spp_cut_from=8,
               predicted_render_s=predicted_s, wall_s=wall, camera_ms=cam_ms,
               camera_ms_median=float(np.median(cam_ms)) if cam_ms else None,
               transforms_max_err=transforms_err, image_min=min(img_min),
               image_mean=float(np.mean(img_mean)), points=int(pc["points"].shape[0]))
    phase("generate_dataset_cli", **res)
    details["generate_dataset_cli"] = res
    if len(cam_ms) != n_cams:
        problems.append(f"{len(cam_ms)} camera render times printed for {n_cams} cameras")
    if min(img_min) < 0.0 or transforms_err > 1e-6:
        problems.append(f"image minimum {min(img_min)}, transforms {transforms_err} off the rig")
    if problems:
        fail("generate_dataset_cli: " + "; ".join(problems))
    return res


# ---- 37. data parallelism: ranks on the one card --------------------------

# W gloo ranks share the one card (NCCL refuses two ranks on one device;
# gloo moves CUDA tensors through the host); then one NCCL rank runs the
# same code, the path a multi-card host takes
DP_WORLD, DP_TIMEOUT, DP_SEED = 2, 600, 5
# ---- 38. the early-exit walk of the fused forward ---------------------------

# Phase 38's synthetic set (phase 3's shapes, every live opacity 0.99), used
# only when neither the refine CLI's nor the profiler's frame gives a launch
# with tiles that stop early and tiles that walk every live segment
EE_SYNTH = dict(t=64, r=512, s=2048, seg=256, sh_k=4, seed=38)
# beta under early exit against the plain version's (compare's max_rel,
# |diff| / max(|beta|, 1e-6)): within EE_BETA_RTOL, or within twice the same
# launch's deviation with the flag off, whichever is larger. The kernel sums
# log1p(-alpha) in stream order and the plain version per segment with
# torch.cumsum, so the two betas differ by a few 1e-6 relative wherever a
# ray has many hits, with the flag on and off alike; a tile that stops at
# another segment fails walked_equal.
EE_BETA_RTOL = 1e-6


@torch.no_grad()
def early_exit_check(composite3, a, reps=10) -> dict:
    """One recorded ``composite3._launch`` tuple ``a`` (early exit on,
    compaction off) replayed with the flag on and off, each against its
    plain version (check_fwd3: L within ATOL / RTOL and KILL_FLIP, walked
    and live equal per tile), beta under early exit as EE_BETA_RTOL says,
    and the forward's bound on the segments each walk reads (fwd_work)."""
    on, off = a[:11] + (True,), a[:11] + (False,)
    r_on, r_off = check_fwd3(composite3, on, reps), check_fwd3(composite3, off, reps)
    w_on, w_off = fwd_work(composite3, on), fwd_work(composite3, off)
    row = dict(tiles=r_on["tiles"], rays=r_on["rays"], S=r_on["S"], order_band=a[10],
               on={k: r_on[k] for k in ("L", "beta", "walked_equal", "ms", "plain_ms", "walked",
                                        "live", "tiles_stopped_early", "tiles_walked_whole")},
               off={k: r_off[k] for k in ("L", "beta", "walked_equal", "ms", "plain_ms",
                                          "walked", "live")},
               bound_ms=w_on["fwd_bound_ms"], bound_by=w_on["fwd_bound_by"],
               bound_ms_off=w_off["fwd_bound_ms"], pairs=w_on["pairs"], pairs_off=w_off["pairs"])
    row["beta_limit"] = max(EE_BETA_RTOL, 2.0 * r_off["beta"]["max_rel"])
    row["ok"] = r_on["ok"] and r_off["ok"] and r_on["beta"]["max_rel"] <= row["beta_limit"]
    return row


def early_exit_phase(composite3, rf_tiled, scene, cameras_json, dev, details) -> dict:
    """Phase 38: the fused forward's early-exit walk (early_exit on,
    compaction off: the TPU kernel's while loop, which stops a tile before
    the first segment at which every ray is capped or at or below
    log(beta_kill)) on the refine CLI's configuration (its 8 cameras at
    64^2, as phase 25) and the profiler frame's (512^2, spp 2, refine
    0.125) on the headline scene: each driven once with the counts set to
    0 just before and read just after, then every launch replayed with the
    flag on and off against the plain versions (:func:`early_exit_check`).
    Some launch must hold tiles that stop early and tiles that walk every
    live segment; if none does, phase 3's synthetic tiles with every live
    opacity at 0.99 are added (EE_SYNTH)."""
    from volprim_tpu_torch import train
    from volprim_tpu_torch.examples import refine_3dg_dataset as refine
    from volprim_tpu_torch.scene import JSONCameraSpecsIO, synthetic
    from volprim_tpu_torch.tools import profile_rf

    t_phase = time.perf_counter()
    cameras = refine.select_cameras(JSONCameraSpecsIO.load(cameras_json), 8, 0.125)
    rcfg = refine.tiled_config(cameras[0], 128, "gaussian")
    pargs = profile_rf._parser().parse_args([])
    pcfg, pcam = profile_rf.config(pargs), synthetic.headline_camera(profile_rf.WIDTH)
    pstate = rf_tiled.build_state(scene, pcfg)
    sets, launches = {}, 0
    for name, fn in (
        ("refine_cli", lambda: train.render_cameras(scene, cameras, rcfg, spp=1, seed=0)),
        ("profiler_frame", lambda: rf_tiled.render_state(pstate, pcam, pcfg, None,
                                                         spp=pargs.spp, seed=0)),
    ):
        with torch.no_grad():
            _, n, rec = record_launches(composite3, "_launch", composite3.composite_tiles3, fn)
        if not n or n != len(rec) or not all(a[11] and not a[9] for a in rec):
            fail(f"early_exit ({name}): {n} launches, or one without early exit or with "
                 "compaction")
        launches += n
        sets[name] = rec
    del pstate
    rows = {name: [early_exit_check(composite3, a) for a in rec] for name, rec in sets.items()}
    mixed = [name for name, rs in rows.items()
             if any(r_["on"]["tiles_stopped_early"] and r_["on"]["tiles_walked_whole"]
                    for r_ in rs)]
    if not mixed:
        c = EE_SYNTH
        d8, pf, sh3, n_seg_t = composite3.synthetic_tiles(c["t"], c["r"], c["s"], c["seg"],
                                                          c["sh_k"], seed=c["seed"], device=dev)
        pf[:, 12] = torch.where(pf[:, 12] > 0.0, 0.99, 0.0)
        a = (d8, pf, sh3, n_seg_t, c["seg"], 9.0, 128, 0.01, c["sh_k"], False, 0, True)
        rows["synthetic"] = [early_exit_check(composite3, a)]
        if rows["synthetic"][0]["on"]["tiles_stopped_early"]:
            mixed.append("synthetic")
    for name, rs in rows.items():
        for r_ in rs:
            phase("early_exit_launch", set=name, **r_)
    path = [r_ for name in sets for r_ in rows[name]]
    res = dict(
        launches=launches, sets_with_early_stops=mixed,
        ms=sum(r_["on"]["ms"] for r_ in path), ms_off=sum(r_["off"]["ms"] for r_ in path),
        plain_ms=sum(r_["on"]["plain_ms"] for r_ in path),
        bound_ms=sum(r_["bound_ms"] for r_ in path),
        bound_by=max(path, key=lambda r_: r_["bound_ms"])["bound_by"],
        bound_ms_off=sum(r_["bound_ms_off"] for r_ in path),
        segments_walked=sum(r_["on"]["walked"] for r_ in path),
        segments_walked_off=sum(r_["off"]["walked"] for r_ in path),
        segments_live=sum(r_["on"]["live"] for r_ in path),
        tiles_stopped_early={name: sum(r_["on"]["tiles_stopped_early"] for r_ in rs)
                             for name, rs in rows.items()},
        max_abs_err=max(r_[v][x]["max_abs"] for rs in rows.values() for r_ in rs
                        for v in ("on", "off") for x in ("L", "beta")),
        beta_max_rel=max(r_["on"]["beta"]["max_rel"] for rs in rows.values() for r_ in rs),
        beta_max_rel_flag_off=max(r_["off"]["beta"]["max_rel"] for rs in rows.values()
                                  for r_ in rs),
        seconds=round(time.perf_counter() - t_phase, 2),
    )
    phase("early_exit", **res)
    details["early_exit"] = dict(res, rows=rows)
    if not mixed:
        fail("early_exit: no input set holds tiles that stop early and tiles that do not")
    bad = [(name, i) for name, rs in rows.items() for i, r_ in enumerate(rs) if not r_["ok"]]
    if bad:
        fail(f"early_exit: launches disagree with their plain versions: {bad}")
    return res


# ---- 39. the path tracer's stage profilers ----------------------------------

# the profilers' film side and repetitions in phase 39 (their defaults: 256, 3)
PRB_PROFILE_RES, PRB_PROFILE_REPS = 256, 2


def prb_profiler_phase(details) -> dict:
    """Phase 39: tools/profile_prb (--quick plus its two walk=pallas rows)
    and tools/ff_attrib in-process at PRB_PROFILE_RES^2, PRB_PROFILE_REPS
    reps: their rows and summaries are printed; the walk=pallas rows must
    have launched csrc/ffwalk.cu, and every _FF_STOP stage must take no
    longer than the full free_flight (random xi) by more than the spread of
    the two rows' reps (a check of the stops, not a claim of speed)."""
    from volprim_tpu_torch.tools import ff_attrib, profile_prb

    t_phase = time.perf_counter()
    common = ["--res", str(PRB_PROFILE_RES), "--reps", str(PRB_PROFILE_REPS)]
    prof = profile_prb.main(["--quick", "--rows", "walk=pallas,walk=pallas exact", *common])
    attrib = ff_attrib.main(common)
    full = attrib["reps"]["full_xi_rand"]
    stops = {}
    for stop in ("collect", "escape", "sort"):
        ts = attrib["reps"][stop]
        spread = (max(ts) - min(ts)) + (max(full) - min(full))
        stops[stop] = dict(ms=attrib[stop], full_ms=attrib["full_xi_rand"], spread_ms=spread,
                           ok=attrib[stop] <= attrib["full_xi_rand"] + spread)
    res = dict(
        rows={k: v for k, v in prof.items() if isinstance(v, float)},
        window_stats=prof["window_stats"], walk_launches=prof["walk_launches"],
        ff_attrib={k: v for k, v in attrib.items() if k != "reps"}, stops=stops,
        seconds=round(time.perf_counter() - t_phase, 2),
    )
    phase("prb_profiler", **res)
    details["prb_profiler"] = dict(res, ff_attrib_reps=attrib["reps"])
    if sorted(prof["walk_launches"]) != ["walk=pallas", "walk=pallas exact"] or not all(
            prof["walk_launches"].values()):
        fail(f"prb_profiler: the walk=pallas rows did not launch the walk kernel: "
             f"{prof['walk_launches']}")
    slow = [k for k, v in stops.items() if not v["ok"]]
    if slow:
        fail(f"prb_profiler: stage stops slower than the full free_flight: {slow} {stops}")
    return res


# ---- 40. the quality studies ---------------------------------------------

# convergence_eval's steps and diag2m's primitives in phase 40 (their
# defaults: 150 and 2,097,152); the headline frame's floor against exact
QS_ITERS, QS_DIAG_PRIMS, QS_PSNR_DB = 20, 262144, 20.0


def run_tool(main, argv) -> dict:
    """A tool's ``main(argv)`` in-process with its output captured and then
    echoed: the JSON object of its last line, which must equal what main
    returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    last = json.loads(text.strip().splitlines()[-1])
    if last != json.loads(json.dumps(res)):
        fail(f"{main.__module__}: its JSON line differs from its result")
    return last


def replay_bwd(composite3, a, reps=3) -> dict:
    """A recorded ``composite3._launch_bwd`` argument tuple replayed through
    the wrapper against the plain version, as phase 7 replays its step's
    (:func:`check_bwd`: gradients held to the f64 yardstick by
    compare_grads), with both times."""
    d8, pf, sh3, n_seg_t, g_l, g_beta, seg, extent2, max_depth, beta_kill, sh_k, compact, band = a
    bkw = dict(seg=seg, extent2=extent2, max_depth=max_depth, beta_kill=beta_kill, sh_k=sh_k,
               order_band=band)
    cmp_, ms, plain_ms = check_bwd(composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta), bkw,
                                   compact, reps)
    cmp_["gpf"].pop("rows")
    return dict(tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
                compact=bool(compact), order_band=band, **cmp_, ms=ms, plain_ms=plain_ms)


def same_inputs(a, b) -> bool:
    """Two recorded launches' argument tuples equal, element for element."""
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))


def quality_studies_phase(composite3, details) -> dict:
    """Phase 40: convergence_eval (fused, QS_ITERS steps), analyze_rf (its
    defaults) and diag2m (its default configurations and the noise floor
    on QS_DIAG_PRIMS primitives), in-process; their JSON lines checked.
    The fused training's forward and backward launches, and analyze_rf's
    forward launches, are recorded (counts set to 0 just before each tool,
    read just after): the first and last training steps' launches, and the
    first frame's launch at each of analyze_rf's budgets, replayed against
    the plain versions (:func:`check_fwd3`, :func:`replay_bwd`); the other
    timed frames of a budget must have had the same inputs. Gates: the
    fused fit ends above its initial scene's held-out PSNR, and both of
    analyze_rf's frames score at least QS_PSNR_DB against the card-made
    exact reference."""
    from volprim_tpu_torch.tools import analyze_rf, convergence_eval, diag2m

    t_phase = time.perf_counter()
    fwd, bwd = composite3.composite_tiles3, composite3.composite_tiles3_bwd
    (conv, n_bwd, rec_b), n_fwd, rec_f = record_launches(
        composite3, "_launch", fwd,
        lambda: record_launches(composite3, "_launch_bwd", bwd, lambda: run_tool(
            convergence_eval.main, ["--iters", str(QS_ITERS), "--backend", "fused"])))
    if (n_fwd, n_bwd, len(rec_f), len(rec_b)) != (QS_ITERS,) * 4 or (
            conv["launches_fwd"], conv["launches_bwd"]) != (QS_ITERS, QS_ITERS):
        fail(f"quality_studies: convergence_eval's fused training launched the forward "
             f"{n_fwd} and the backward {n_bwd} times (the tool counted "
             f"{conv['launches_fwd']}, {conv['launches_bwd']}), expected {QS_ITERS} each")
    steps = {}
    for i in (0, QS_ITERS - 1):
        steps[i] = dict(fwd=check_fwd3(composite3, rec_f[i], reps=3),
                        bwd=replay_bwd(composite3, rec_b[i]))
        phase("quality_studies_train_step", step=i, **steps[i])
    del rec_f, rec_b

    frames = 1 + analyze_rf.FRAME_REPS  # the frames analyze_rf renders a budget
    ana, n_ana, rec_a = record_launches(composite3, "_launch", fwd,
                                        lambda: run_tool(analyze_rf.main, []))
    if n_ana != 2 * frames or len(rec_a) != 2 * frames:
        fail(f"quality_studies: analyze_rf's frames launched the forward {n_ana} times "
             f"({len(rec_a)} recorded), expected {2 * frames} (one a frame)")
    budgets = {}
    for mc, first in ((ana["mc"], 0), (4 * ana["mc"], frames)):
        row = check_fwd3(composite3, rec_a[first], reps=3)
        row["timed_frames_same_inputs"] = all(
            same_inputs(rec_a[first], rec_a[first + k]) for k in range(1, frames))
        budgets[mc] = row
        phase("quality_studies_frame", mc=mc, **row)
        if row["S"] != mc:
            fail(f"quality_studies: analyze_rf's frame at {mc} candidates launched the "
                 f"forward on {row['S']} columns")
    del rec_a

    diag = run_tool(diag2m.main, ["--prims", str(QS_DIAG_PRIMS), *diag2m.DEFAULT, "noise"])
    frame_db = {int(k): v for k, v in ana["quality"]["psnr_db"].items()}
    psnrs = ([conv[k] for k in ("psnr_init", "psnr_tiled", "psnr_exact")]
             + list(frame_db.values())
             + [c["psnr_db"] for c in diag["configs"].values()] + [diag["noise"]["psnr_db"]])
    res = dict(
        convergence=dict(psnr_init=conv["psnr_init"], psnr_tiled=conv["psnr_tiled"],
                         psnr_exact=conv["psnr_exact"], ms_per_step=conv["ms_per_step"],
                         launches_fwd=n_fwd, launches_bwd=n_bwd,
                         replayed_ok={i: st["fwd"]["ok"] and st["bwd"]["ok"]
                                      for i, st in steps.items()}),
        analyze_rf=dict(psnr_db=ana["quality"]["psnr_db"], need_mean=ana["need"]["mean"],
                        exact_s=ana["exact"]["seconds"],
                        noise_floor_db=ana["exact"]["noise_floor_db"], launches=n_ana,
                        replayed_ok={mc: r["ok"] and r["timed_frames_same_inputs"]
                                     for mc, r in budgets.items()}),
        diag2m=dict(psnr_db={k: c["psnr_db"] for k, c in diag["configs"].items()},
                    noise_db=diag["noise"]["psnr_db"], exact_s=diag["exact"]["seconds"]),
        seconds=round(time.perf_counter() - t_phase, 2),
    )
    phase("quality_studies", **res)
    details["quality_studies"] = dict(convergence_eval=conv, analyze_rf=ana, diag2m=diag,
                                      train_steps=steps, frames=budgets)
    if not all(math.isfinite(v) for v in psnrs):
        fail(f"quality_studies: a PSNR is not finite: {psnrs}")
    if not all(res["convergence"]["replayed_ok"].values()):
        fail(f"quality_studies: a compositor kernel disagrees with its plain version on "
             f"convergence_eval's training steps {res['convergence']['replayed_ok']}")
    if not all(res["analyze_rf"]["replayed_ok"].values()):
        fail(f"quality_studies: the forward kernel disagrees with its plain version on "
             f"analyze_rf's frames, or a timed frame's inputs changed "
             f"{res['analyze_rf']['replayed_ok']}")
    if not conv["psnr_tiled"] > conv["psnr_init"]:
        fail(f"quality_studies: the fused fit scores {conv['psnr_tiled']:.2f} dB held out, "
             f"not above its initial scene's {conv['psnr_init']:.2f}")
    low = {mc: db for mc, db in frame_db.items() if not db >= QS_PSNR_DB}
    if low:
        fail(f"quality_studies: analyze_rf's frames score {low} dB against the card-made "
             f"exact reference (floor {QS_PSNR_DB})")
    return res


# ---- 41. the root studies -------------------------------------------------

# refine_truck's and truck_bound's depth in phase 41 (their defaults: 1,048,576
# splats, 256^2, 4 spp, 256 steps); band262k's floor against exact
RS_SPLATS, RS_RES, RS_SPP, RS_ITERS, RS_PSNR_DB = 131072, 64, 2, 16, 20.0
RS_DIR = os.path.join("build", "chip_smoke_truck")


def replay_summary(rows, kind) -> dict:
    """The replays of a set of launches: all within tolerance, the largest
    errors, the kernel's and the plain version's ms summed."""
    keys = ("L", "beta") if kind == "fwd" else ("gpf", "gsh")
    return dict(ok=all(r_["ok"] for r_ in rows), launches=len(rows),
                max_abs={k: max(r_[k]["max_abs"] for r_ in rows) for k in keys},
                ms=sum(r_["ms"] for r_ in rows), plain_ms=sum(r_["plain_ms"] for r_ in rows))


def root_studies_phase(composite3, details) -> dict:
    """Phase 41: refine_truck (RS_SPLATS splats, RS_RES^2, RS_SPP spp,
    RS_ITERS steps, --perturb strong, 8 + 2 cameras, its own workdir
    RS_DIR), truck_bound on its held-out images at the same size and spp,
    and band262k at its defaults, in-process; their JSON lines checked.
    refine_truck's fused launches are recorded (counts set to 0 just before
    the tool, read just after) and split by the tool's own counts into the
    refine CLI's steps (a forward and a backward launch per camera a step,
    early exit on) and the three tiled evaluations: the first and last
    steps' launches and each evaluation's first launch are replayed against
    the plain versions at phase 7's tolerances (:func:`check_fwd3`,
    :func:`replay_bwd`). Gates: the CLI's loss falls; the refined asset's
    tiled held-out PSNR lies above its initial asset's (the exact-scored
    PSNRs are recorded only); 8,192 candidates bound no lower than 2,048;
    every band262k row scores at least RS_PSNR_DB against the card-made
    exact reference and mc4096-csort-band16 not below mc4096."""
    import shutil

    from volprim_tpu_torch.tools import band262k, refine_truck, truck_bound

    t_phase = time.perf_counter()
    shutil.rmtree(RS_DIR, ignore_errors=True)
    fwd, bwd = composite3.composite_tiles3, composite3.composite_tiles3_bwd
    argv = ["--n_splats", str(RS_SPLATS), "--res", str(RS_RES), "--spp", str(RS_SPP),
            "--iterations", str(RS_ITERS), "--perturb", "strong", "--workdir", RS_DIR]
    (truck, n_bwd, rec_b), n_fwd, rec_f = record_launches(
        composite3, "_launch", fwd,
        lambda: record_launches(composite3, "_launch_bwd", bwd,
                                lambda: run_tool(refine_truck.main, argv)))
    counted, cams = truck["launches"], truck["train_cams"]
    evals = counted["tiled_eval_fwd"]
    n_train = RS_ITERS * cams
    if ((counted["train_fwd"], counted["train_bwd"], n_bwd, len(rec_b)) != (n_train,) * 4
            or not n_fwd == len(rec_f) == n_train + sum(evals.values())
            or not all(evals.values()) or not all(a[11] for a in rec_f)):
        fail(f"root_studies: refine_truck launched the forward {n_fwd} and the backward "
             f"{n_bwd} times (the tool counted {counted}), expected {n_train} each in "
             f"training plus the tiled evaluations' forwards, all with early exit")
    steps, bounds = {}, {}
    for i in (0, RS_ITERS - 1):
        sl = slice(i * cams, (i + 1) * cams)
        steps[i] = dict(
            fwd=replay_summary([check_fwd3(composite3, a, reps=3) for a in rec_f[sl]], "fwd"),
            bwd=replay_summary([replay_bwd(composite3, a) for a in rec_b[sl]], "bwd"))
        phase("root_studies_train_step", step=i, **steps[i])
    bounds["fwd"] = [fwd_work(composite3, a) for a in rec_f[:cams]]
    bounds["bwd"] = [bwd_work(composite3, a) for a in rec_b[:cams]]
    evals_rows, first = {}, n_train
    for key, n in evals.items():
        evals_rows[key] = check_fwd3(composite3, rec_f[first], reps=3)
        phase("root_studies_tiled_eval", scene=key, launches=n, **evals_rows[key])
        first += n
    del rec_f, rec_b

    images = os.path.join(RS_DIR, "images")
    bound = run_tool(truck_bound.main, ["--n_splats", str(RS_SPLATS), "--res", str(RS_RES),
                                        "--spp", str(RS_SPP), "--images", images])
    band = run_tool(band262k.main, [])
    band_db = {k: v["psnr_db"] for k, v in band["configs"].items()}
    fwd_b = [w["fwd_bound_ms"] for w in bounds["fwd"]]
    bwd_b = [w["bwd_bound_ms"] for w in bounds["bwd"]]
    res = dict(
        refine_truck=dict(
            psnr_db=truck["psnr_db"], loss_first=truck["loss_first"],
            loss_last=truck["loss_last"], seconds=truck["seconds"],
            train_wall_s=truck["train_wall_s"], train_peak_gib=truck["train_peak_gib"],
            launches_fwd=n_fwd, launches_bwd=n_bwd, launches_train=n_train,
            launches_tiled_eval=evals,
            replayed_ok={**{f"step{i}": st["fwd"]["ok"] and st["bwd"]["ok"]
                            for i, st in steps.items()},
                         **{f"eval_{k}": r_["ok"] for k, r_ in evals_rows.items()}}),
        step_kernels=dict(
            fwd_ms=steps[0]["fwd"]["ms"], fwd_plain_ms=steps[0]["fwd"]["plain_ms"],
            fwd_bound_ms=sum(fwd_b),
            fwd_bound_by=max(bounds["fwd"], key=lambda w: w["fwd_bound_ms"])["fwd_bound_by"],
            bwd_ms=steps[0]["bwd"]["ms"], bwd_plain_ms=steps[0]["bwd"]["plain_ms"],
            bwd_bound_ms=sum(bwd_b),
            bwd_bound_by=max(bounds["bwd"], key=lambda w: w["bwd_bound_ms"])["bwd_bound_by"]),
        truck_bound={k: v for k, v in bound.items() if k.startswith("bound_mc")},
        band262k=dict(psnr_db=band_db, exact_s=band["exact"]["seconds"],
                      seconds={k: v["seconds"] for k, v in band["configs"].items()}),
        seconds=round(time.perf_counter() - t_phase, 2),
    )
    res["max_abs_err"] = max([st["fwd"]["max_abs"][x] for st in steps.values()
                              for x in ("L", "beta")]
                             + [r_[x]["max_abs"] for r_ in evals_rows.values()
                                for x in ("L", "beta")])
    res["max_abs_err_bwd"] = max(st["bwd"]["max_abs"][x] for st in steps.values()
                                 for x in ("gpf", "gsh"))
    phase("root_studies", **res)
    details["root_studies"] = dict(refine_truck=truck, truck_bound=bound, band262k=band,
                                   train_steps=steps, tiled_evals=evals_rows)
    psnrs = list(truck["psnr_db"].values()) + list(band_db.values()) + [
        v for k, v in bound.items() if k.startswith("bound_mc")]
    if not all(math.isfinite(v) for v in psnrs):
        fail(f"root_studies: a PSNR is not finite: {psnrs}")
    if not all(res["refine_truck"]["replayed_ok"].values()):
        fail(f"root_studies: a compositor kernel disagrees with its plain version on "
             f"refine_truck's launches {res['refine_truck']['replayed_ok']}")
    if not truck["loss_last"] < truck["loss_first"]:
        fail(f"root_studies: the refine CLI's loss went {truck['loss_first']} -> "
             f"{truck['loss_last']}")
    p = truck["psnr_db"]
    if not p["refined_tiled"] > p["init_tiled"]:
        fail(f"root_studies: the refined asset scores {p['refined_tiled']:.2f} dB tiled held "
             f"out, not above its initial asset's {p['init_tiled']:.2f}")
    if not bound["bound_mc8192_db"] >= bound["bound_mc2048_db"]:
        fail(f"root_studies: truck_bound at 8,192 candidates {bound['bound_mc8192_db']} dB, "
             f"below 2,048's {bound['bound_mc2048_db']}")
    low = {k: db for k, db in band_db.items() if not db >= RS_PSNR_DB}
    if low:
        fail(f"root_studies: band262k rows score {low} dB against the card-made exact "
             f"reference (floor {RS_PSNR_DB})")
    if not band_db["mc4096-csort-band16"] >= band_db["mc4096"]:
        fail(f"root_studies: band262k's mc4096-csort-band16 {band_db['mc4096-csort-band16']:.2f}"
             f" dB below mc4096's {band_db['mc4096']:.2f}")
    return res


DP_DIR = os.path.join("build", "chip_smoke_dp")
# the dryrun's batch-sensor step (__graft_entry__.dryrun_multichip: rf at
# max_depth 8, L1 against a zero image, BoundedAdam at lr 1e-2 with bounded
# opacities) on the headline scene at the refine CLI's 8 cameras of 64^2
# (phase 25); rf's chunk is the port's default (the dryrun's 64 is sized
# for its 64-primitive scene)
DP_BATCH_RF = dict(max_depth=8)
DP_CAMS, DP_CAM_SCALE = 8, 0.125
# The sharded gradients against the single process's. Every gradient
# within DP_GRAD_RTOL in norm (||g - g1|| <= DP_GRAD_RTOL ||g1||); the
# opacities, the parameter of test_sharding.py's gradient test, also per
# element at its rtol and atol (the atol raised to twice the largest
# deviation of two single-process steps from each other, where their sums
# are not reproducible). The other elements are not held one by one: the
# ranks sum their blocks' parts before the all-reduce, in another order
# than one process: centers, scales and quats sum cancelling f32 terms,
# the SH rows' gradients are bf16 sums (on an H100 80GB HBM3 at the
# headline scene, two ranks: single elements up to 1.1e-4 of the largest
# scale gradient and 0.30% of the largest SH gradient, 5.1e-6 and 3.5e-4
# in norm).
DP_GRAD_RTOL, DP_GRAD_ATOL = 1e-3, 1e-8
DP_PSNR_DB = 25.0


def dp_train_step(scene, camera, mesh):
    """train.train_step (TRAIN, 1 spp, L1 against a zero image,
    make_optimizer's BoundedAdam) on fresh copies of the scene's five
    parameters, replicated over ``mesh``: (loss, gradients, parameters
    after the step)."""
    from volprim_tpu_torch import interop, parallel, train
    from volprim_tpu_torch.models import rf_tiled

    params = {k: (getattr(scene, k) if hasattr(scene, k) else scene.attrs[k]).clone()
              for k in interop.TRAIN_KEYS}
    parallel.replicate(mesh, params)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    zero = torch.zeros((camera.height, camera.width, 3), device=scene.device)
    loss = train.train_step(params, train.make_optimizer(), zero, [camera],
                            rf_tiled.RFTiledConfig(**TRAIN), spp=1, seed=0, base=scene,
                            mesh=mesh)[0]
    return (loss, {k: p.grad for k, p in params.items()},
            {k: p.detach() for k, p in params.items()})


def dp_batch_step(scene, cameras, mesh):
    """The dryrun's batch-sensor step on ``mesh``: render_batch with
    rf.radiance, L1, parallel.sharded_grad_step, BoundedAdam: (loss,
    gradients, parameters after the step)."""
    from volprim_tpu_torch import models, parallel
    from volprim_tpu_torch.models import rf
    from volprim_tpu_torch.optim import BoundedAdam, l1
    from volprim_tpu_torch.scene import EllipsoidScene

    dev = scene.device
    params = {"opacities": scene.attrs["opacities"].clone(),
              "sh_coeffs": scene.attrs["sh_coeffs"].clone(), "centers": scene.centers.clone()}
    parallel.replicate(mesh, params)
    cfg = rf.RFConfig(**DP_BATCH_RF)
    ref = torch.zeros((cameras[0].height, len(cameras) * cameras[0].width, 3), device=dev)

    def loss_fn(p):
        s = EllipsoidScene(p["centers"], scene.scales, scene.quats,
                           {"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]},
                           scene.extent)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return l1(ref, models.render_batch(s, cameras, rf.radiance, cfg, None, spp=1,
                                           generator=gen, mesh=mesh))

    loss, grads = parallel.sharded_grad_step(loss_fn, mesh)(params)
    opt = BoundedAdam(lr=1e-2)
    opt.set_bounds("opacities", lower=1e-6, upper=1.0 - 1e-6)
    opt.step(params, grads)
    return loss, grads, params


def dp_batch_cameras():
    from volprim_tpu_torch.examples import refine_3dg_dataset as refine
    from volprim_tpu_torch.scene import synthetic

    return refine.select_cameras(synthetic.orbit_cameras(WIDTH, DP_CAMS), DP_CAMS, DP_CAM_SCALE)


def grad_dev(got, want, floor: float = 0.0) -> dict:
    """``got`` against ``want``: the largest deviation, alone and over
    want's largest |value|, and the elements outside rtol DP_GRAD_RTOL and
    atol max(DP_GRAD_ATOL, 2 ``floor``), ``floor`` the largest deviation
    of two single-process runs from each other."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    atol = max(DP_GRAD_ATOL, 2.0 * floor)
    bad = diff > DP_GRAD_RTOL * want.abs() + atol
    return {"max_dev": float(diff.max()),
            "max_dev_share": float(diff.max()) / max(float(want.abs().max()), 1e-30),
            "norm_dev": float(torch.linalg.vector_norm(got - want))
            / max(float(torch.linalg.vector_norm(want)), 1e-30),
            "atol": atol, "outside": int(bad.sum()), "elements": want.numel()}


def dp_rank(args) -> None:
    """One rank of phase 37 (chip_smoke.py --dp_rank R --dp_world W
    --dp_port P --dp_backend gloo|nccl): join the group, render and step on
    the mesh against the parent's single-process results in DP_DIR, and
    write what it measured there as rank<R>_<backend>.json."""
    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        fail("no CUDA card")
    import torch.distributed as dist

    from volprim_tpu_torch import parallel
    from volprim_tpu_torch.kernels import _build, composite3
    from volprim_tpu_torch.models import rf_tiled
    from volprim_tpu_torch.scene import synthetic

    for name in ("composite3_fwd", "composite3_bwd"):  # built by the parent (phase 2)
        if not _build.library_path(name).exists():
            fail(f"{name} is not built")
        _build.load(name)
    rank, world, backend = args.dp_rank, args.dp_world, args.dp_backend
    if not parallel.init_multihost(f"127.0.0.1:{args.dp_port}", world, rank, timeout_s=300,
                                   backend=backend):
        fail(f"rank {rank} could not join the {backend} group")
    mesh = parallel.data_mesh("cuda")
    dev = mesh.device
    ref = torch.load(os.path.join(DP_DIR, "reference.pt"), map_location=dev)
    torch.cuda.reset_peak_memory_stats(dev)  # (after the first allocation on dev)
    floor = ref.pop("floor")
    scene = synthetic.make_scene(N_PRIMS, device=dev)
    camera = synthetic.headline_camera(WIDTH)
    fwd, bwd = composite3.composite_tiles3, composite3.composite_tiles3_bwd
    res = dict(backend=backend, world=world, rank=rank, device=str(dev))

    def counted(fn):
        fwd.launches = bwd.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, fwd.launches, bwd.launches

    cfg_t, cfg_h = rf_tiled.RFTiledConfig(**TRAIN), rf_tiled.RFTiledConfig(**HEADLINE)
    state_t, state_h = rf_tiled.build_state(scene, cfg_t), rf_tiled.build_state(scene, cfg_h)
    seeds = iter(range(1000, 2000))
    with torch.no_grad():
        for tag, state, cfg in (("train", state_t, cfg_t), ("headline", state_h, cfg_h)):
            img, n_fwd, _ = counted(lambda: rf_tiled.render_state(
                state, camera, cfg, None, spp=SPP, seed=DP_SEED, mesh=mesh))
            want = ref[f"{tag}_frame"]
            res[f"{tag}_frame"] = dict(
                bitwise=bool(torch.equal(img, want)),
                max_abs=float((img - want).abs().max()), psnr_db=psnr_db(img, want),
                launches=n_fwd, finite=bool(torch.isfinite(img).all()),
                ms=cuda_times(lambda: rf_tiled.render_state(
                    state, camera, cfg, None, spp=SPP, seed=next(seeds), mesh=mesh), 5, 1))
    # the collectives alone, at the frame's and the step's sizes
    n_tiles = (WIDTH * WIDTH) // TRAIN["tile_pixels"]
    blk = torch.zeros((n_tiles // mesh.size, TRAIN["tile_pixels"], 3), device=dev)
    res["gather_frame_ms"] = cuda_ms(lambda: parallel.gather_blocks(mesh, blk), 10)
    (loss, grads, params), n_fwd, n_bwd = counted(lambda: dp_train_step(scene, camera, mesh))
    bufs = [g.clone() for g in grads.values()]
    res["sum_grads_step_ms"] = cuda_ms(lambda: parallel.sum_grads(mesh, bufs), 5)
    del bufs
    res["train_step"] = dict(
        loss=float(loss), loss_ref=float(ref["train_loss"]), launches_fwd=n_fwd,
        launches_bwd=n_bwd,
        grads={k: grad_dev(g, ref[f"train_grad_{k}"], floor[f"train_{k}"])
               for k, g in grads.items()},
        params_max_dev={k: float((p - ref[f"train_param_{k}"]).abs().max())
                        for k, p in params.items()},
        params_equal_across_ranks=dp_replicas_equal(mesh, params),
        ms=cuda_times(lambda: dp_train_step(scene, camera, mesh), 3, 1))
    del grads, params
    cams = dp_batch_cameras()
    t0 = time.perf_counter()
    loss, grads, params = dp_batch_step(scene, cams, mesh)
    torch.cuda.synchronize()
    res["batch_step"] = dict(
        loss=float(loss), loss_ref=float(ref["batch_loss"]),
        grads={k: grad_dev(g, ref[f"batch_grad_{k}"], floor[f"batch_{k}"])
               for k, g in grads.items()},
        params_max_dev={k: float((p - ref[f"batch_param_{k}"]).abs().max())
                        for k, p in params.items()},
        params_equal_across_ranks=dp_replicas_equal(mesh, params),
        s=time.perf_counter() - t0)
    film = torch.zeros((cams[0].height, DP_CAMS * cams[0].width, 4), device=dev)
    res["sum_film_batch_ms"] = cuda_ms(lambda: parallel.sum_parts(mesh, film), 5)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(os.path.join(DP_DIR, f"rank{rank}_{backend}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dp_replicas_equal(mesh, params) -> bool:
    """Every tensor of ``params`` equal to rank 0's, on this rank."""
    import torch.distributed as dist

    same = True
    for p in params.values():
        p0 = p.detach().clone()
        dist.broadcast(p0, 0, group=mesh.group)
        same = same and bool(torch.equal(p0, p))
    return same


def dp_launch(backend: str, world: int) -> list:
    """Start ``world`` ranks of this script on the card, wait for them all
    (DP_TIMEOUT, a failed rank ends the others) and read their results."""
    with socketlib.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = []
    for r in range(world):
        log = open(os.path.join(DP_DIR, f"rank{r}_{backend}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp_rank", str(r), "--dp_world",
             str(world), "--dp_port", str(port), "--dp_backend", backend],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.perf_counter() + DP_TIMEOUT
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(DP_DIR, f"rank{r}_{backend}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"data_parallel: {backend} rank {r} of {world} exited {p.returncode} "
                 f"(timeout {DP_TIMEOUT} s):\n{tail}")
    rows = []
    for r in range(world):
        with open(os.path.join(DP_DIR, f"rank{r}_{backend}.json")) as f:
            rows.append(json.load(f))
    return rows


def data_parallel(scene, details) -> dict:
    """Phase 37: the headline scene's frames and steps on W = DP_WORLD gloo
    ranks sharing the card, then on one NCCL rank, against this process's
    single-process results: the TRAIN frame bit for bit, the HEADLINE
    frame (budget classes chosen per block) above DP_PSNR_DB, the train
    step's and the batch-sensor step's gradients within DP_GRAD_RTOL, the
    parameters after each step equal on every rank. Prints one line a
    rank; returns the compositor launches the ranks made."""
    from volprim_tpu_torch.models import rf_tiled
    from volprim_tpu_torch.scene import synthetic

    t_phase = time.perf_counter()
    os.makedirs(DP_DIR, exist_ok=True)
    camera = synthetic.headline_camera(WIDTH)
    ref = {}
    with torch.no_grad():
        for tag, kw in (("train", TRAIN), ("headline", HEADLINE)):
            cfg = rf_tiled.RFTiledConfig(**kw)
            ref[f"{tag}_frame"] = rf_tiled.render_state(rf_tiled.build_state(scene, cfg), camera,
                                                        cfg, None, spp=SPP, seed=DP_SEED)
    # each step twice: the second run's deviation from the first (the
    # scatter-adds' order) sets each gradient's absolute floor
    floor, single = {}, {}
    cams = dp_batch_cameras()
    for tag, step in (("train", lambda: dp_train_step(scene, camera, None)),
                      ("batch", lambda: dp_batch_step(scene, cams, None))):
        t0 = time.perf_counter()
        loss, grads, params = step()
        torch.cuda.synchronize()
        single[f"{tag}_step_s"] = time.perf_counter() - t0
        again = step()[1]
        ref[f"{tag}_loss"] = loss
        for k, g in grads.items():
            ref[f"{tag}_grad_{k}"], ref[f"{tag}_param_{k}"] = g, params[k]
            floor[f"{tag}_{k}"] = grad_dev(again[k], g)["max_dev"]
        del grads, params, again
    # the single process's times beside the ranks' (CUDA events, as there)
    seeds = iter(range(1000, 2000))
    with torch.no_grad():
        for tag, kw in (("train", TRAIN), ("headline", HEADLINE)):
            cfg = rf_tiled.RFTiledConfig(**kw)
            state = rf_tiled.build_state(scene, cfg)
            single[f"{tag}_frame_ms"] = cuda_times(lambda: rf_tiled.render_state(
                state, camera, cfg, None, spp=SPP, seed=next(seeds)), 5, 1)
            del state
    single["train_step_ms"] = cuda_times(lambda: dp_train_step(scene, camera, None), 3, 1)
    torch.save({**{k: v.detach().cpu() for k, v in ref.items()}, "floor": floor},
               os.path.join(DP_DIR, "reference.pt"))
    del ref
    torch.cuda.empty_cache()  # the ranks need the card's memory
    runs = {"gloo": dp_launch("gloo", DP_WORLD), "nccl": dp_launch("nccl", 1)}
    problems = []
    for backend, rows in runs.items():
        for row in rows:
            phase("data_parallel", **row)
            who = f"{backend} rank {row['rank']} of {row['world']}"
            if not (row["train_frame"]["bitwise"] and row["train_frame"]["finite"]):
                problems.append(f"{who}: the TRAIN frame differs from the single process's "
                                f"(max {row['train_frame']['max_abs']})")
            if not row["headline_frame"]["psnr_db"] > DP_PSNR_DB:
                problems.append(f"{who}: HEADLINE frame {row['headline_frame']['psnr_db']} dB")
            for step in ("train_step", "batch_step"):
                s = row[step]
                bad = {k: v for k, v in s["grads"].items()
                       if not v["norm_dev"] <= DP_GRAD_RTOL
                       or (k == "opacities" and v["outside"])}
                if bad:
                    problems.append(f"{who}: {step} gradients off the single process's: {bad}")
                if not s["params_equal_across_ranks"]:
                    problems.append(f"{who}: {step} parameters differ across ranks")
            ts = row["train_step"]
            if not (row["train_frame"]["launches"] and ts["launches_fwd"]
                    and ts["launches_bwd"]):
                problems.append(f"{who}: a compositor kernel was not launched")
    res = dict(single_process=single, single_vs_single_max_dev=floor,
               seconds=round(time.perf_counter() - t_phase, 2),
               launches_fwd={b: [r_["train_frame"]["launches"] + r_["headline_frame"]["launches"]
                                 + r_["train_step"]["launches_fwd"] for r_ in rows]
                             for b, rows in runs.items()},
               launches_bwd={b: [r_["train_step"]["launches_bwd"] for r_ in rows]
                             for b, rows in runs.items()})
    phase("data_parallel_total", **res)
    details["data_parallel"] = dict(res, runs=runs)
    if problems:
        fail("data_parallel: " + "; ".join(problems))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for details and a profiler table")
    # one rank of phase 37, started by the phase itself (dp_launch)
    ap.add_argument("--dp_rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp_world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp_port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp_backend", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        dp_rank(args)
        return
    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False); the port's "
             "kernels have no CPU mode here")

    from volprim_tpu_torch.kernels import _build, clone, composite3, ffwalk
    from volprim_tpu_torch.models import prb, render, rf, rf_tiled
    from volprim_tpu_torch.ops import envmap
    from volprim_tpu_torch.scene import CameraSpecs, generate_rays, look_at, synthetic

    dev = torch.device("cuda", 0)
    details = {}
    t_start = time.perf_counter()

    # ---- 1. probe -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unavailable"
    print(smi_line, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the quadric math must stay full f32")
    details["probe"] = dict(
        device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        count=torch.cuda.device_count(), nvidia_smi=smi_line,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )
    phase("probe", **details["probe"])

    # ---- 2. build: one nvcc per source, all started together ------------
    t0 = time.perf_counter()
    names = ("composite3_fwd", "composite3_bwd", "composite3_fwd_abl", "ffwalk",
             "composite_fwd", "composite_bwd", "composite2_fwd", "composite2_bwd", "clone")
    _build.build(*names)
    for name in names:
        _build.load(name)
    seconds = round(time.perf_counter() - t0, 2)
    spilled = []
    for name in names:
        info = _build.build_info.get(name, {})
        table = ptxas_table(_build.build_log(name))
        phase("build", kernel=name, seconds=seconds,
              nvcc_seconds=round(info.get("seconds", 0.0), 2), instantiations=len(table))
        for row in table:
            if row["kernel"]:  # the compositors and the walk: one line per instantiation
                phase("ptxas", source=name, kernel=row["kernel"], args=row["args"],
                      registers=row["registers"], spill_stores=row.get("spill_stores"),
                      spill_loads=row.get("spill_loads"), stack=row.get("stack"))
            if spill_gated(name, row) and row.get("spill_stores", 0):
                spilled.append(row)
        details.setdefault("build", {})[name] = dict(seconds=seconds, ptxas=table)
    if spilled:
        fail(f"instantiations on the path spill (compositors at k = 4, the walk at k <= 32): "
             f"{spilled}")

    # ---- 3. kernel vs plain version at the headline shapes ---------------
    checks = []
    kw = dict(seg=256, extent2=9.0, max_depth=128, beta_kill=0.01, sh_k=4)
    for s in (2048, 8192):
        inputs = composite3.synthetic_tiles(64, 512, s, 256, 4, seed=s, device=dev)
        plain_ms = cuda_ms(lambda: composite3.composite_tiles3_reference(*inputs, **kw), 20)
        for compact in (False, True):
            want = composite3.composite_tiles3_reference(*inputs, compact=compact, **kw)
            got = composite3.composite_tiles3(*inputs, compact=compact, **kw)
            torch.cuda.synchronize()
            cl = compare(got[0], want[0], 64 * 512)
            cb = compare(got[1], want[1], 64 * 512)
            ms = cuda_ms(lambda: composite3.composite_tiles3(*inputs, compact=compact, **kw), 20)
            row = dict(S=s, compact=compact, L=cl, beta=cb, ms=ms, plain_ms=plain_ms)
            checks.append(row)
            phase("kernel", **row)
            if not (cl["ok"] and cb["ok"]):
                fail(f"kernel disagrees with its plain version at S={s} compact={compact}")
    details["kernel_checks"] = checks

    # ---- 4. main path ---------------------------------------------------
    t0 = time.perf_counter()
    scene = synthetic.make_scene(N_PRIMS, device=dev)
    cfg = rf_tiled.RFTiledConfig(**HEADLINE)
    camera = synthetic.headline_camera(WIDTH)
    state = rf_tiled.build_state(scene, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_ms = cuda_ms(lambda: rf_tiled.build_state(scene, cfg), 3, warmup=1)

    def frame(seed=0):
        return rf_tiled.render_state(state, camera, cfg, None, spp=SPP, seed=seed)

    # the counted run: launch counts reset just before, read just after;
    # the launch arguments are recorded on the way (the recorder wraps the
    # launch helper, so the count stays on composite_tiles3)
    img, launches, recorded = record_launches(composite3, "_launch",
                                              composite3.composite_tiles3,
                                              lambda: frame(seed=1))
    n_classes = len(cfg.budget_classes)
    fold = max(1, min(SPP, 512 // cfg.tile_pixels))
    while SPP % fold:
        fold -= 1
    if launches != n_classes * (SPP // fold) or launches != len(recorded):
        fail(f"composite_tiles3 launched {launches} times, expected "
             f"{n_classes * (SPP // fold)} (one per budget class and sample group)")
    if tuple(img.shape) != (WIDTH, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        fail("the frame is not a finite [512, 512, 3] image")
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(100, 200))
    frame_times = cuda_times(lambda: frame(next(seeds)), 10)
    frame_ms = float(np.median(frame_times))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mrays = WIDTH * WIDTH * SPP / (frame_ms / 1e3) / 1e6
    details["main_path"] = dict(
        launches=launches, frame_ms=frame_ms,
        frame_ms_min=frame_times[0], frame_ms_max=frame_times[-1], mrays_per_s=mrays,
        peak_mem_gib=peak_gib, mean_radiance=float(img.mean()),
        build_state_ms=build_ms, setup_s=round(setup_s, 2),
        class_tiles=[int(a[0].shape[0]) for a in recorded],
        class_columns=[int(a[1].shape[2]) for a in recorded],
    )
    phase("main_path", **details["main_path"])

    # the kernel against its plain version on the frame's own inputs
    path_checks, path_ms, path_plain_ms = [], 0.0, 0.0
    for d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k, compact, *_ in recorded:
        inputs = (d8, pf, sh3, n_seg_t)
        kw = dict(seg=seg, extent2=extent2, max_depth=max_depth,
                  beta_kill=beta_kill, sh_k=sh_k)
        want = composite3.composite_tiles3_reference(*inputs, compact=compact, **kw)
        got = composite3.composite_tiles3(*inputs, compact=compact, **kw)
        torch.cuda.synchronize()
        n_rays = d8.shape[0] * d8.shape[2]
        cl, cb = compare(got[0], want[0], n_rays), compare(got[1], want[1], n_rays)
        ms = cuda_ms(lambda: composite3.composite_tiles3(*inputs, compact=compact, **kw), 10)
        # the same launch with compaction flipped: what compaction buys
        ms_flipped = cuda_ms(
            lambda: composite3.composite_tiles3(*inputs, compact=not compact, **kw), 10
        )
        plain_ms = cuda_ms(
            lambda: composite3.composite_tiles3_reference(*inputs, **kw), 3, warmup=1
        )
        path_ms += ms
        path_plain_ms += plain_ms
        row = dict(tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
                   compact=compact, L=cl, beta=cb, ms=ms, ms_compact_flipped=ms_flipped,
                   plain_ms=plain_ms)
        path_checks.append(row)
        phase("kernel_on_frame_inputs", **row)
        if not (cl["ok"] and cb["ok"]):
            fail("kernel disagrees with its plain version on the frame's inputs")
    details["frame_kernel_checks"] = path_checks

    # ---- 5. quality vs the exact-order integrator ------------------------
    img1 = rf_tiled.render_state(state, camera, cfg, None, spp=1, seed=0, jitter=False)
    o, d = generate_rays(camera, jitter=False, device=dev)
    sel = torch.from_numpy(
        np.random.default_rng(0).choice(WIDTH * WIDTH, size=4096, replace=False)
    ).to(dev)
    t0 = time.perf_counter()
    o_sel, d_sel = o[sel], d[sel]  # (phase 22 scores its Epanechnikov frame on them)
    exact = rf.radiance(scene, None, o_sel, d_sel, rf.RFConfig(
        max_depth=128, srgb_primitives=True, chunk_size=2048))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    tiled = img1.reshape(-1, 3)[sel]
    if not bool(torch.isfinite(exact).all()):
        fail("the exact-order reference is not finite")
    mse = float(torch.mean((tiled - exact) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-12))
    details["quality"] = dict(psnr_vs_exact_db=psnr, pixels=4096, exact_s=round(exact_s, 2),
                              mean_tiled=float(tiled.mean()), mean_exact=float(exact.mean()))
    phase("quality", **details["quality"])
    if not psnr > 20.0:
        fail(f"PSNR vs the exact-order integrator is {psnr:.2f} dB")
    frame_work = [fwd_work(composite3, a) for a in recorded]
    phase("frame_kernel_work", classes=frame_work)
    details["frame_kernel_work"] = frame_work

    # ---- 6. backward kernel vs plain version, synthetic inputs ------------
    bwd_checks, band_checks = [], []
    kw = dict(seg=256, extent2=9.0, max_depth=128, beta_kill=0.01, sh_k=4)
    for r in (256, 512):
        inputs = composite3.synthetic_tiles(64, r, 2048, 256, 4, seed=r, device=dev)
        rng = np.random.default_rng(r)
        cot = [torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32)).to(dev)
               for shape in ((64, r, 3), (64, r))]
        for compact, band in ((False, 0), (True, 0), (False, BAND_SYNTH), (True, BAND_SYNTH)):
            if band:  # the forward, banded: its only check off band 16
                f_row = check_fwd3(composite3, (*inputs, kw["seg"], kw["extent2"], kw["max_depth"],
                                                 kw["beta_kill"], kw["sh_k"], compact, band,
                                                 False))
                phase("fwd_kernel_banded", R=r, **f_row)
                band_checks.append(f_row)
                if not f_row["ok"]:
                    fail(f"banded forward kernel disagrees with its plain version at R={r} "
                         f"compact={compact} order_band={band}")
            cmp_, ms, plain_ms = check_bwd(composite3, (*inputs, *cot),
                                           dict(kw, order_band=band), compact, 20)
            row = dict(T=64, R=r, S=2048, compact=compact, order_band=band, **cmp_, ms=ms,
                       plain_ms=plain_ms)
            bwd_checks.append(row)
            phase("bwd_kernel", **row)
            if not cmp_["ok"]:
                fail(f"backward kernel disagrees with its plain version at R={r} "
                     f"compact={compact} order_band={band}")
    details["bwd_kernel_checks"] = bwd_checks
    details["fwd_kernel_banded_checks"] = band_checks

    # ---- 7. the train step at full width ---------------------------------
    from volprim_tpu_torch import interop, train

    tcfg = rf_tiled.RFTiledConfig(**TRAIN)
    base = synthetic.make_scene(N_PRIMS, device=dev)
    params = {
        "centers": base.centers, "scales": base.scales, "quats": base.quats,
        "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"],
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def bench_step(seed):
        for p in params.values():
            p.grad = None
        img = train.render_cameras(train.to_scene(params, base), [camera], tcfg,
                                   spp=1, seed=seed)
        loss = torch.mean(torch.abs(img))  # L1 against a zero image (bench.py)
        loss.backward()
        return loss.detach()

    composite3.composite_tiles3.launches = 0
    loss0, n_bwd, recorded_bwd = record_launches(composite3, "_launch_bwd",
                                                 composite3.composite_tiles3_bwd,
                                                 lambda: bench_step(0))
    step_launches = (composite3.composite_tiles3.launches, n_bwd)
    if step_launches != (1, 1) or len(recorded_bwd) != 1:
        fail(f"the train step launched (forward, backward) {step_launches} times, "
             "expected (1, 1)")
    grad_stats = {}
    for k in interop.TRAIN_KEYS:
        g = params[k].grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"the gradient of {k} is missing, not finite or all zero")
        grad_stats[k] = float(g.abs().max())
    torch.cuda.reset_peak_memory_stats()
    step_times = cuda_times(lambda: bench_step(1), 5, warmup=1)
    step_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    d8, pf, sh3, n_seg_t, g_l, g_beta, seg, extent2, max_depth, beta_kill, sh_k, compact, _ = (
        recorded_bwd[0])
    bkw = dict(seg=seg, extent2=extent2, max_depth=max_depth, beta_kill=beta_kill,
               sh_k=sh_k)
    train_work = work(composite3, d8, pf, sh3, n_seg_t, seg, extent2, max_depth, sh_k,
                      compact)
    # the forward kernel against its plain version on the step's inputs
    # (256-ray tiles: its only check at this block size)
    fwd_inputs = (d8, pf, sh3, n_seg_t)
    want = composite3.composite_tiles3_reference(*fwd_inputs, compact=compact, **bkw)
    got = composite3.composite_tiles3(*fwd_inputs, compact=compact, **bkw)
    torch.cuda.synchronize()
    n_rays = d8.shape[0] * d8.shape[2]
    cl, cb = compare(got[0], want[0], n_rays), compare(got[1], want[1], n_rays)
    del want, got
    fwd_train_ms = cuda_ms(
        lambda: composite3.composite_tiles3(*fwd_inputs, compact=compact, **bkw), 10
    )
    fwd_train_plain_ms = cuda_ms(
        lambda: composite3.composite_tiles3_reference(*fwd_inputs, **bkw), 3, warmup=1
    )
    fwd_step_row = dict(L=cl, beta=cb, ms=fwd_train_ms, plain_ms=fwd_train_plain_ms)
    phase("fwd_kernel_on_step_inputs", **fwd_step_row)
    details["train_step_fwd"] = fwd_step_row
    if not (cl["ok"] and cb["ok"]):
        fail("forward kernel disagrees with its plain version on the step's inputs")
    step_ms = float(np.median(step_times))
    if args.out:
        busy_ms = device_profile(lambda i: bench_step(10 + i), args.out,
                                 "chip_smoke_train_profile.txt")
        details["train_device_busy_ms_per_step"] = busy_ms
        details["train_device_idle_share"] = 1.0 - busy_ms / step_ms
    phase(
        "train_step", launches_fwd=step_launches[0], launches_bwd=step_launches[1],
        loss=float(loss0), step_ms=step_ms,
        step_ms_min=step_times[0], step_ms_max=step_times[-1],
        peak_mem_gib=step_peak_gib, grad_max_abs=grad_stats,
        tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
        fwd_kernel_ms=fwd_train_ms,
        device_busy_ms=details.get("train_device_busy_ms_per_step"),
        device_idle_share=details.get("train_device_idle_share"), **train_work,
    )
    cmp_, bwd_ms, bwd_plain_ms = check_bwd(
        composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta), bkw, compact
    )
    row = dict(**cmp_, ms=bwd_ms, plain_ms=bwd_plain_ms,
               step_share=(bwd_ms + fwd_train_ms) / step_ms)
    phase("bwd_kernel_on_step_inputs", **row)
    details["train_step"] = dict(step_times=step_times, bwd=row, work=train_work)
    if not cmp_["ok"]:
        fail("backward kernel disagrees with its plain version on the step's inputs")
    del recorded_bwd, d8, pf, sh3, g_l, g_beta, params

    # ---- 8. the refine loop through train.train_step ---------------------
    cameras = [camera, CameraSpecs(
        name="side", width=WIDTH, height=WIDTH,
        to_world=look_at([1.6, 0.6, -2.8], [0, 0, 0], [0, 1, 0]), fov=50.0,
    )]
    with torch.no_grad():
        ref = train.render_cameras(base, cameras, tcfg, spp=4, seed=999)
    rng = np.random.default_rng(8)
    start = {
        "opacities": base.attrs["opacities"].cpu().numpy() * 0.5,
        "sh_coeffs": base.attrs["sh_coeffs"].cpu().numpy()
        + rng.normal(0.0, 0.05, tuple(base.attrs["sh_coeffs"].shape)).astype(np.float32),
        "centers": base.centers.cpu().numpy(),
    }
    lparams = interop.params_from_jax(start, device=dev)
    opt = train.make_optimizer()
    losses = []
    for it in range(8):
        t0 = time.perf_counter()
        loss, psnr_t, _ = train.train_step(lparams, opt, ref, cameras, tcfg, spp=1,
                                           seed=it, base=base)
        loss, psnr_t = float(loss), float(psnr_t)  # synchronises
        losses.append(loss)
        phase("train_loop", step=it + 1, loss=loss, psnr_db=psnr_t,
              ms=(time.perf_counter() - t0) * 1e3)
    o = lparams["opacities"].detach()
    lo, hi = train.OPACITY_BOUNDS
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the refine loop's loss did not fall: {losses}")
    if not (float(o.min()) >= lo and float(o.max()) <= hi):
        fail("the opacities left their bounds")
    details["train_loop_losses"] = losses
    del lparams, opt, ref, base

    # ---- 9. the free-flight walk kernel vs its plain version --------------
    medium = synthetic.make_medium(PRB_PRIMS, seed=0, device=dev)
    pcam = synthetic.medium_camera(PRB_WIDTH, PRB_WIDTH)
    po, pd = generate_rays(pcam, jitter=False, device=dev)
    q = PRB_WIDTH // 4
    center = (slice(q, 3 * q), slice(q, 3 * q))  # the central 256 x 256 = 65,536 rays
    tables = ffwalk.synthetic_tables(
        medium, po.reshape(PRB_WIDTH, PRB_WIDTH, 3)[center].reshape(-1, 3).contiguous(),
        pd.reshape(PRB_WIDTH, PRB_WIDTH, 3)[center].reshape(-1, 3).contiguous(), 256, seed=9,
    )
    walk_checks = []
    for name in ffwalk.WALK_VARIANTS:
        tb, kw = ffwalk.walk_variant(tables, name, seed=9)
        wargs, wkw = list(tb.values()), walk_kwargs(kw)
        n0 = ffwalk.walk.launches
        got = ffwalk.walk(*wargs, **wkw)
        want = ffwalk.walk_reference(*wargs, **wkw)
        torch.cuda.synchronize()
        if ffwalk.walk.launches != n0 + 1:
            fail(f"ffwalk.walk did not launch its kernel once in variant {name}")
        cmp_ = compare_walk(got, want, int(tb["active"].sum()))
        del got, want
        ms = launch_ms(lambda: ffwalk._launch(*wargs, **wkw), 10)
        plain_ms = cuda_ms(lambda: ffwalk.walk_reference(*wargs, **wkw), 3, warmup=1)
        wk = {}
        ffwalk.walk_reference(*wargs, **wkw, work=wk)
        row = dict(variant=name, kp=int(tb["entry"].shape[1]), **kw, **cmp_, ms=ms,
                   plain_ms=plain_ms, **walk_work(wargs, kw, wk))
        walk_checks.append(row)
        phase("ffwalk_kernel", **row)
        if not cmp_["ok"]:
            fail(f"the walk kernel disagrees with its plain version in variant {name}")
    details["ffwalk_checks"] = walk_checks
    del tables, tb, wargs

    # ---- 10. the path tracer's frame through the walk kernel -------------
    sky = envmap.procedural_sky(device=dev)
    pcfg = prb.PRBConfig(max_depth=-1, walk_backend="pallas")

    def prb_frame(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return render(medium, pcam, prb.radiance, pcfg, sky, 1, gen)

    # The counted frame. Hooks record the bounce of each free flight (prb.
    # _bounce's argument i), its live, found and dead rays (and at bounce 0
    # its xi and dead mask, for phase 11), and the inputs of each walk
    # launch. Afterwards every launch is replayed through ffwalk.walk against
    # the plain version on its own inputs, both timed.
    hooked = dict(_launch=ffwalk._launch, _bounce=prb._bounce, free_flight=prb.free_flight)
    bounce_sig = inspect.signature(prb._bounce)
    bounce_now = {"i": 0}
    ff_stats, bounce0, recorded_walks = {}, [], []

    def bounce_hook(*a, **k):
        bounce_now["i"] = bounce_sig.bind(*a, **k).arguments["i"]
        return hooked["_bounce"](*a, **k)

    def ff_hook(prims, o, d, xi, cfg, active, *a, **k):
        out = hooked["free_flight"](prims, o, d, xi, cfg, active, *a, **k)
        st = ff_stats.setdefault(bounce_now["i"], dict(live=0, found=0, dead=0))
        st["live"] += int(active.sum())
        st["found"] += int(out[0].sum())
        st["dead"] += int(out[1].sum())
        if bounce_now["i"] == 0:
            bounce0.append((xi, out[1]))
        return out

    def launch_hook(*a, **k):
        recorded_walks.append((bounce_now["i"], a, k))
        return hooked["_launch"](*a, **k)

    ffwalk._launch, prb._bounce, prb.free_flight = launch_hook, bounce_hook, ff_hook
    ffwalk.walk.launches = 0
    try:
        t0 = time.perf_counter()
        pimg = prb_frame(1)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    finally:
        prb_launches = ffwalk.walk.launches
        ffwalk._launch, prb._bounce, prb.free_flight = hooked.values()
    # a bounce with found or dead rays had needy rays: the walk decided them
    needy_bounces = {b for b, st in ff_stats.items() if st["found"] + st["dead"]}
    walk_bounces = {b for b, _, _ in recorded_walks}
    if prb_launches == 0 or prb_launches != len(recorded_walks) or needy_bounces - walk_bounces:
        fail(f"ffwalk launched {prb_launches} times ({len(recorded_walks)} recorded) on "
             f"bounces {sorted(walk_bounces)} of those with needy rays {sorted(needy_bounces)}")
    if tuple(pimg.shape) != (PRB_WIDTH, PRB_WIDTH, 3) or not bool(torch.isfinite(pimg).all()):
        fail("the path-traced frame is not a finite [512, 512, 3] image")
    launch_rows = []
    for bounce, a, k in recorded_walks:
        n0 = ffwalk.walk.launches
        got = ffwalk.walk(*a, **k)
        want = ffwalk.walk_reference(*a, **k)
        torch.cuda.synchronize()
        if ffwalk.walk.launches != n0 + 1:
            fail("ffwalk.walk did not launch its kernel once on a replayed launch")
        cmp_ = compare_walk(got, want, int(a[8].sum()))  # a[8]: active
        wk = {}
        ffwalk.walk_reference(*a, **k, work=wk)
        launch_rows.append(dict(
            bounce=bounce, rays=int(a[0].shape[0]), kp=int(a[0].shape[1]), **cmp_,
            ms=launch_ms(lambda: ffwalk._launch(*a, **k), 5),
            plain_ms=cuda_ms(lambda: ffwalk.walk_reference(*a, **k), 2, warmup=1),
            **walk_work(a, k, wk),
        ))
    walk_kernel_ms = kernel_device_ms(
        lambda: [ffwalk._launch(*a, **k) for _, a, k in recorded_walks], "ffwalk_kernel")
    del recorded_walks, got, want
    walk_ms = sum(r_["ms"] for r_ in launch_rows)
    walk_plain_ms = sum(r_["plain_ms"] for r_ in launch_rows)
    walk_bound_ms = sum(r_["bound_ms"] for r_ in launch_rows)
    bound_bytes = sum(r_["bound_ms"] for r_ in launch_rows if r_["bound_by"] == "bytes")
    later = [r_ for r_ in launch_rows if r_["bounce"] > 0]
    shown = [r_ for r_ in launch_rows if r_["bounce"] == 0]
    if later:
        shown.append(max(later, key=lambda r_: r_["rays"]))
    for row in shown:
        phase("ffwalk_on_frame_inputs", **{k_: v for k_, v in row.items() if k_ != "work"})
    bad = [r_ for r_ in launch_rows if not r_["ok"]]
    if bad:
        fail(f"the walk kernel disagrees with its plain version on {len(bad)} of the frame's "
             f"{len(launch_rows)} launches")
    walked = sum(st["live"] for st in ff_stats.values())
    dead = sum(st["dead"] for st in ff_stats.values())
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(500, 600))
    prb_times = cuda_times(lambda: prb_frame(next(seeds)), 3, warmup=1)
    prb_ms = float(np.median(prb_times))
    prb_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    phase(
        "prb_frame", launches=prb_launches, frame_ms=prb_ms, frame_ms_min=prb_times[0],
        frame_ms_max=prb_times[-1], mrays_per_s=PRB_WIDTH * PRB_WIDTH / (prb_ms / 1e3) / 1e6,
        bounces=len(ff_stats), rays_walked=walked, dead_share=dead / max(walked, 1),
        dead_share_bounce0=ff_stats[0]["dead"] / max(ff_stats[0]["live"], 1),
        mean_radiance=[float(x) for x in pimg.reshape(-1, 3).mean(0)],
        peak_mem_gib=prb_peak_gib, counted_frame_s=round(counted_s, 2),
        walk_ms_per_frame=walk_ms, walk_kernel_ms_per_frame=walk_kernel_ms,
        walk_plain_ms_per_frame=walk_plain_ms,
        walk_bound_ms_per_frame=walk_bound_ms,
        walk_bytes_per_frame=sum(r_["bytes"] for r_ in launch_rows),
        walk_design_bytes_per_frame=sum(r_["design_bytes"] for r_ in launch_rows),
        walk_rays_per_frame=sum(r_["rays"] for r_ in launch_rows),
        walk_launches_compared=len(launch_rows),
        walk_rays_differ=sum(r_["decisions_differ"] + r_["t_outside_tol"] for r_ in launch_rows),
    )
    details["prb_frame"] = dict(times=prb_times, launches=launch_rows,
                                bounce_stats={str(b): v for b, v in ff_stats.items()})

    # ---- 11. an analytic check of the whole path: absorbing plume --------
    dark = dataclasses.replace(medium, attrs={
        **medium.attrs, "albedo": torch.zeros_like(medium.attrs["albedo"])})
    unit = envmap.ConstantEmitter(radiance=torch.ones(3, device=dev))
    ff_stats.clear()
    bounce0.clear()
    prb._bounce, prb.free_flight = bounce_hook, ff_hook
    try:
        lum = prb.radiance(dark, unit, po, pd, pcfg, torch.Generator(device=dev).manual_seed(11))
    finally:
        prb._bounce, prb.free_flight = hooked["_bounce"], hooked["free_flight"]
    trans = prb.transmittance(medium, po, pd, pcfg)
    n_rays = po.shape[0]
    # bounce 0 sees every camera ray, chunk after chunk, in order
    xi0 = torch.cat([x for x, _ in bounce0])
    dead0 = torch.cat([m for _, m in bounce0])
    if xi0.shape[0] != n_rays:
        fail(f"absorbing plume: bounce 0 saw {xi0.shape[0]} of {n_rays} rays")
    # With albedo 0 a path ends at its first free flight, and L is 1 exactly
    # when that flight escapes. A ray escapes in closed form when its depth
    # chi = -log(xi) exceeds the whole ray's (xi <= T); only the others go to
    # the walk, so the exact L of every budget-dead ray is 0 as well, and
    # the walk can move L only by letting a crossing ray (xi > T) escape.
    # Hence E[mean L] = mean T up to such rays (counted), and the limit is
    # 4 standard errors of mean L alone.
    l0 = lum[:, 0]
    crossing = xi0 > trans
    mean_l, mean_t = float(l0.mean()), float(trans.mean())
    limit = 4.0 * math.sqrt(float(torch.sum(trans * (1.0 - trans)))) / n_rays
    dead_lit = int((dead0 & (l0 != 0)).sum())
    phase("prb_absorbing", rays=n_rays, mean_radiance=mean_l, mean_transmittance=mean_t,
          diff=abs(mean_l - mean_t), limit=limit,
          dead_share=float(dead0.float().mean()), dead_rays_with_light=dead_lit,
          crossing_rays_escaped=int((crossing & (l0 == 1)).sum()),
          escaping_rays_dark=int((~crossing & (l0 == 0)).sum()),
          values_in_0_1=bool(((lum == 0) | (lum == 1)).all()))
    if not bool(torch.isfinite(lum).all()) or not abs(mean_l - mean_t) <= limit or dead_lit:
        fail(f"absorbing plume: mean L {mean_l} vs mean T {mean_t}, limit {limit}, "
             f"{dead_lit} budget-dead rays with light")

    # ---- 12-15. the v1 and v2 compositors: frames and train steps ---------
    v12 = {}
    for backend, tag in (("pallas", "v1"), ("pallas2", "v2")):
        v12[f"{tag}_fwd"] = v12_frame(backend, f"{tag}_frame", scene, camera, exact, sel,
                                      img1, details, args.out)
        v12[f"{tag}_bwd"] = v12_train_step(backend, f"{tag}_train_step", camera, dev,
                                           details, args.out)
        v12[f"{tag}_fwd"]["fwd_step_err"] = v12[f"{tag}_bwd"]["fwd_max_abs_err"]

    # ---- 16-19. the profiler's path, its probe, the order band ------------
    clone_row = clone_check(clone, dev, details)
    prof = profiler_phase(composite3, clone, rf_tiled, scene, camera, exact, sel, details)
    band = band_frames(composite3, rf_tiled, scene, camera, exact, sel, details)
    band_step = replay_train_step(composite3, camera, dev, details, "band_train_step",
                                  order_band=16)
    # ---- 20. quaternions off unit length: the warp cull's radius ----------
    drift_step = replay_train_step(composite3, camera, dev, details, "quat_drift_step",
                                   quat_norm=0.9, kernel_compact=False)

    # ---- 21-25. the 3DGS-asset path: PLY and cameras, the xla route, ----
    # emitters and the two CLIs
    paths = asset_io(scene, details)
    asset_ply, asset_cams = paths["ply"], paths["cameras"]
    xla_frame(rf_tiled, rf, scene, camera, exact, sel, o_sel, d_sel, details, args.out)
    xla_train_step(rf_tiled, camera, dev, details)
    emitter_check(composite3, rf_tiled, scene, camera, details)
    cli = cli_phase(composite3, rf_tiled, paths, scene, dev, details)

    # ---- 26-29. the volume-fitting path (no kernel of its own) ------------
    tomography_frame(dev, details)
    tomography_step(dev, details, args.out)
    gridvol_reference(dev, details)
    volume_clis(dev, details)

    # ---- 30-33. the rest of the path tracer: the xla walk, the sequential
    # and cluster walks, coeff_gemm, Epanechnikov, surfaces, render_volume
    jump_stats = frame_stats(pimg)
    prb_xla_frame(medium, pcam, po, pd, sky, jump_stats, dev, details)
    paths = prb_walk_paths(ffwalk, medium, pcam, po, pd, sky, dev, details)
    surf = prb_surfaces(ffwalk, medium, pcam, sky, dev, details)
    render_volume_cli(details)

    # ---- 34-36. the tooling: the radiance cache and radiosity fit, SH
    # fitting and the visualizer, the generate_dataset CLI
    rad = radiosity_fit(ffwalk, dev, details, args.out)
    sh_fit_visualizer(rad["cache"], rad["mesh"], dev, details)
    generate_dataset_cli(asset_ply, exact_s, dev, details)
    # ---- 37. data parallelism: gloo ranks on the card, one NCCL rank -----
    dp = data_parallel(scene, details)
    # ---- 38. the fused forward's early-exit walk ---------------------------
    ee = early_exit_phase(composite3, rf_tiled, scene, asset_cams, dev, details)
    # ---- 39. the path tracer's stage profilers -----------------------------
    prb_prof = prb_profiler_phase(details)
    # ---- 40. the quality studies ---------------------------------------------
    quality_studies_phase(composite3, details)
    # ---- 41. the root studies ------------------------------------------------
    rs = root_studies_phase(composite3, details)
    new_walks = {"sequential": paths["sequential_pallas"]["walk"],
                 "clusters": paths["clusters_pallas"]["walk"],
                 "coeff_gemm": paths["coeff_gemm_pallas"]["walk"], "surfaces": surf["walk"],
                 "radiance_cache": rad["walk"]}

    if args.out:
        busy_ms, split = device_profile(
            lambda i: prb_frame(700 + i), args.out, "chip_smoke_prb_profile.txt",
            stages={prb: ("optical_depth", "_gather_intervals", "_run_windows_pallas",
                          "_f_exact_at"),
                    ffwalk: ("_launch",)},
        )
        details["prb_device_busy_ms_per_frame"] = busy_ms
        details["prb_device_idle_share"] = 1.0 - busy_ms / prb_ms
        details["prb_device_ms_per_frame_by_stage"] = split
        phase("prb_profile", device_busy_ms_per_frame=busy_ms,
              device_idle_share=details["prb_device_idle_share"], device_ms_by_stage=split)

    if args.out:
        busy_ms = device_profile(lambda i: frame(seed=300 + i), args.out,
                                 "chip_smoke_profile.txt")
        details["device_busy_ms_per_frame"] = busy_ms
        details["device_idle_share"] = 1.0 - busy_ms / frame_ms
        phase("profile", device_busy_ms_per_frame=busy_ms,
              device_idle_share=details["device_idle_share"])
        with open(os.path.join(args.out, "chip_smoke_details.json"), "w") as f:
            json.dump(details, f, indent=1)

    worst = max(
        [c[x]["max_abs"] for c in checks + path_checks + [fwd_step_row]
         for x in ("L", "beta")]
        + [b["max_abs_err"] for b in band]
        + [cli["render_tiled"]["fwd_max_abs_err"], cli["refine_gaussian"]["fwd_max_abs_err"],
           ee["max_abs_err"]]
        + [r_[x]["max_abs"] for r_ in prof["rows"] + [band_step["fwd"], drift_step["fwd"]]
           + band_checks for x in ("L", "beta")]
        + [rs["max_abs_err"]]
    )
    worst_bwd = max(
        [c[x]["max_abs"] for c in bwd_checks + [details["train_step"]["bwd"], band_step["bwd"],
                                                drift_step["bwd"]]
         for x in ("gpf", "gsh")]
        + [cli["refine_gaussian"]["bwd_max_abs_err"], rs["max_abs_err_bwd"]]
    )
    fwd_bound = sum(w["fwd_bound_ms"] for w in frame_work)
    phase("total", seconds=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": [{
        "name": "composite3_fwd",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/composite3_fwd.cu",
        "replaces": "volprim_tpu/pallas_kernels/composite3.py:496",
        "launches": launches,
        "max_abs_err": worst,
        "ms": path_ms,
        "plain_ms": path_plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": max(frame_work, key=lambda w: w["fwd_bound_ms"])["fwd_bound_by"],
        "library_ms": None,
        "launches_train_step": step_launches[0],
        "ms_train_step": fwd_train_ms,
        "plain_ms_train_step": fwd_train_plain_ms,
        "bound_ms_train_step": train_work["fwd_bound_ms"],
        "launches_profiler_path": prof["launches"]["composite3"],
        "launches_band": sum(b["launches"] for b in band),
        "ms_band": sum(b["kernel_ms"] for b in band),
        "plain_ms_band": sum(b["plain_ms"] for b in band),
        "bound_ms_band": sum(b["bound_ms"] for b in band),
        "bound_by_band": max(band, key=lambda b: b["bound_ms"])["bound_by"],
        "launches_cli_render": cli["render_tiled"]["launches"],
        "ms_cli_render": cli["render_tiled"]["fwd_ms"],
        "plain_ms_cli_render": cli["render_tiled"]["fwd_plain_ms"],
        "bound_ms_cli_render": cli["render_tiled"]["fwd_bound_ms"],
        "launches_data_parallel": dp["launches_fwd"],
        "launches_cli_refine": cli["refine_gaussian"]["launches_fwd"],
        "ms_cli_refine": cli["refine_gaussian"]["fwd_ms"],
        "plain_ms_cli_refine": cli["refine_gaussian"]["fwd_plain_ms"],
        "bound_ms_cli_refine": cli["refine_gaussian"]["fwd_bound_ms"],
        "launches_early_exit": ee["launches"],
        "ms_early_exit": ee["ms"],
        "ms_early_exit_flag_off": ee["ms_off"],
        "plain_ms_early_exit": ee["plain_ms"],
        "bound_ms_early_exit": ee["bound_ms"],
        "bound_by_early_exit": ee["bound_by"],
        "segments_walked_early_exit": ee["segments_walked"],
        "segments_live_early_exit": ee["segments_live"],
        "launches_root_studies": rs["refine_truck"]["launches_fwd"],
        "launches_root_studies_train": rs["refine_truck"]["launches_train"],
        "ms_root_studies_step": rs["step_kernels"]["fwd_ms"],
        "plain_ms_root_studies_step": rs["step_kernels"]["fwd_plain_ms"],
        "bound_ms_root_studies_step": rs["step_kernels"]["fwd_bound_ms"],
        "bound_by_root_studies_step": rs["step_kernels"]["fwd_bound_by"],
    }, {
        "name": "composite3_bwd",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/composite3_bwd.cu",
        "replaces": "volprim_tpu/pallas_kernels/composite3.py:830",
        "launches": step_launches[1],
        "max_abs_err": worst_bwd,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": train_work["bwd_bound_ms"],
        "bound_by": train_work["bwd_bound_by"],
        "library_ms": None,
        "launches_band": band_step["launches_bwd"],
        "ms_band": band_step["ms"],
        "plain_ms_band": band_step["plain_ms"],
        "bound_ms_band": band_step["bwd_bound_ms"],
        "bound_by_band": band_step["bwd_bound_by"],
        "launches_data_parallel": dp["launches_bwd"],
        "launches_cli_refine": cli["refine_gaussian"]["launches_bwd"],
        "ms_cli_refine": cli["refine_gaussian"]["bwd_ms"],
        "plain_ms_cli_refine": cli["refine_gaussian"]["bwd_plain_ms"],
        "bound_ms_cli_refine": cli["refine_gaussian"]["bwd_bound_ms"],
        "launches_root_studies": rs["refine_truck"]["launches_bwd"],
        "ms_root_studies_step": rs["step_kernels"]["bwd_ms"],
        "plain_ms_root_studies_step": rs["step_kernels"]["bwd_plain_ms"],
        "bound_ms_root_studies_step": rs["step_kernels"]["bwd_bound_ms"],
        "bound_by_root_studies_step": rs["step_kernels"]["bwd_bound_by"],
    }, {
        "name": "ffwalk",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/ffwalk.cu",
        "replaces": "volprim_tpu/pallas_kernels/ffwalk.py:81",
        "launches": prb_launches,
        "max_abs_err": max([r_["max_abs_dt"] for r_ in walk_checks + launch_rows]
                           + [w["max_abs_dt"] for w in new_walks.values()]),
        "ms": walk_ms,
        "plain_ms": walk_plain_ms,
        "bound_ms": walk_bound_ms,
        "bound_by": "bytes" if bound_bytes >= walk_bound_ms / 2 else "operations",
        "library_ms": None,
        **{f"{key}_{path}": w[field] for path, w in new_walks.items()
           for key, field in (("launches", "launches"), ("ms", "ms"), ("bound_ms", "bound_ms"),
                              ("bound_by", "bound_by"),
                              ("plain_ms_largest_launch", "largest_launch_plain_ms"),
                              ("ms_largest_launch", "largest_launch_ms"))},
        "launches_prb_profiler": prb_prof["walk_launches"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"volprim_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": v12[key]["launches"],
        "max_abs_err": max(v12[key]["max_abs_err"], v12[key].get("fwd_step_err", 0.0)),
        "ms": v12[key]["ms"],
        "plain_ms": v12[key]["plain_ms"],
        "bound_ms": v12[key]["bound_ms"],
        "bound_by": v12[key]["bound_by"],
        "library_ms": None,
    } for name, key, replaces in (
        ("composite_fwd", "v1_fwd", "volprim_tpu/pallas_kernels/composite.py:38"),
        ("composite_bwd", "v1_bwd", "volprim_tpu/pallas_kernels/composite_vjp.py:48"),
        ("composite2_fwd", "v2_fwd", "volprim_tpu/pallas_kernels/composite2.py:105"),
        ("composite2_bwd", "v2_bwd", "volprim_tpu/pallas_kernels/composite2.py:159"),
    )] + [{
        "name": "clone",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/clone.cu",
        "replaces": "tools/profile_rf.py:405",
        "launches": prof["launches"]["clone"],
        "max_abs_err": clone_row["max_abs_err"],
        "ms": clone_row["ms"],
        "plain_ms": clone_row["plain_ms"],
        "bound_ms": clone_row["bound_ms"],
        "bound_by": clone_row["bound_by"],
        "library_ms": None,
        "ratio_4s_over_s": clone_row["ratio_4s_over_s"],
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
