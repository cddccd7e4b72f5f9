#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It imports nothing of JAX.  Phases:

1. device      the card's name and power limit (nvidia-smi), torch, CUDA;
2. build       the transfer kernels, one nvcc per mpm_flip98a_tpu_torch/
               csrc/*.cu (all started together) for sm_90a, and ptxas's
               register and spill report;
3. kernels:2d  p2g_fused and g2p against their plain PyTorch versions on
               the 2D main path's inputs at the bench scale (1M particles,
               513^2 grid, dt = 2e-6: bench.py:179-189) after 20
               substeps, plus P2G's partition of unity there and on a
               ragged synthetic case (PIC linear, and APIC Tait);
               p2g_fused's achieved bytes per second and two reruns
               bitwise equal to a first (it sums in a fixed order) at
               bench 1M and on the ragged APIC Tait case;
4. main:2d     the CLI on dam2d_flip98 (2 frames x 200 substeps), then
               the same Simulation at the bench scale (2 frames x 100
               substeps): launch counters, finite state, no overflow,
               constant mass, every particle in the box;
5. timing:2d   ms per substep and transfer ops/s (n * 9 * 2 * substeps /
               seconds) for the kernel and plain paths, median of 3 x 100
               substeps; each kernel against its plain version by CUDA
               events;
6. kernels:2dp the prepped-P2G branch at the bench scale: stab1M (the
               stabilized switch set, F-bar + penalty + mixing 1.0, on
               the bench dam break: 1M particles, buckets 513 x 4096) and
               drop1M (elastic_drop_2d with that config: 1,059,536
               particles with a 244^2 neo-Hookean block), each after 20
               substeps; p2g against p2g_plain with 9 channels (stab1M),
               6 channels (drop1M's state without F-bar and mixing) and
               9 tent channels on a ragged case at G = 2049 (column
               bands), with its mass sum; g2p with the 7-channel grid and
               with tent taps against g2p_plain; CUDA-event times and
               bounds of p2g and the 7-channel g2p at stab1M; p2g's time at
               drop1M, its achieved bytes per second against the memory
               rate, and two reruns bitwise equal to a first (p2g sums in
               a fixed order) at stab1M (B-spline and tent) and drop1M;
7. main:elastic_drop  the CLI on elastic_drop (11,931 particles, 105^2;
               2 frames x 200 substeps): p2g and g2p launched once per
               substep, p2g_fused never, and the host checks of phase 4;
8. main:stab1M, main:drop1M  Simulation runs of 2 frames x 100 substeps:
               launches, the host checks, and stab1M's J range;
9. timing:2dp  phase 5's timings for stab1M and drop1M (kernel and plain
               paths, median of 3 x 100 substeps);
10. main:dam3d the CLI on dam3d (64^3, 27,648 particles; 2 frames x 100
               substeps): each 3D kernel launched once per substep, the
               2D kernels never, and the host checks of phase 4;
11. main:slab8M the 3D bench and BASELINE.json configs[3] slab (8.4M
               particles, 256^3: bench.py:198-205) through Simulation,
               2 frames x 25 substeps, then one forced rebucket: the host
               checks and the peak device memory (beside the reading with
               the earlier atomic-scatter p2g3d_grid);
12. kernels:3d p2g3d_grid and g2p3d against their plain versions on that
               state and on a ragged synthetic case: P2G's raw sums per
               channel, its mass sum, the finished grid, G2P's outputs;
               p2g3d_grid's plan (at every timed shape of the later
               phases too), two reruns of its stress mode bitwise equal to
               a first and its raw mode at one shard bitwise its raw_out;
13. timing:3d  ms per substep and transfer ops/s (n * 27 * 2 * substeps
               / seconds), median of 3 x 20 substeps, for the kernel path
               at 8M / 256^3 and at 1M / 128^3 and the plain path at
               1M / 128^3; each 3D kernel and its plain version by CUDA
               events at the 8M shapes; the per-substep margin read;
14. main:stab3d-8M  the stabilized switch set (F-bar, penalty EBC, mixing
               1.0; PIC + FLIP 0.98) on the 8M slab through Simulation,
               2 frames x 10 substeps: p2g3d_grid (prepped mode, 11
               channels) and g2p3d (gather mode, 9-channel grid) launched
               once per substep, p2g3d never; the host checks, J within
               0.1 of 1, the peak device memory;
15. main:relfloor3d the same scene with mass_floor = 0 (the relative
               floor): p2g3d and g2p3d once per substep, p2g3d_grid never;
               x, v and J against phase 14's after the same substeps;
16. kernels:3dp  on the stab3d-8M state and on a ragged case (uneven
               counts, out-of-margin slots, slots on the axis-1 and z
               edges): p2g3d (11 channels PIC, 7 channels APIC, tent)
               against p2g3d_plain with its mass sum; p2g3d_grid's prepped
               modes against plain (raw sums and finished grid); g2p3d's
               gather modes against plain; fold_rows0(p2g3d) against the
               interior of p2g3d_grid's raw sums (and whether they are
               bitwise equal: a reading); CUDA-event times and bounds at
               the 8M shapes; p2g3d's plan and achieved bytes per second;
               two reruns bitwise equal to a first there (p2g3d B-spline
               and tent, and on relfloor3d's state; every p2g3d_grid
               prepped mode, whose raw mode at one shard must equal its
               raw_out bitwise);
17. main:drop3d  elastic_drop_3d at 128^3 (3.5M particles, a 51^3
               neo-Hookean block, APIC) through Simulation, 2 frames x 10
               substeps: launches and the host checks; then on that state
               the modes it launched against their plain versions, as in
               phase 16, with times and bounds: p2g3d_grid's prepped mode
               on 25 APIC planes (7 raw channels), g2p3d's gather mode on
               the 6-channel grid, and p2g3d with 7 APIC channels;
18. timing:3dp   phase 13's timings for stab3d-8M, relfloor3d, drop3d
               (kernel and plain paths) and the stabilized set at
               1M / 128^3 (kernel and plain paths); with --profile,
               stab3d-8M's and relfloor3d's device time;
19. main:sharded   bench 1M and stab1M through Simulation(devices=4) (4
               slab shards on the card) against Simulation() from the same
               particles: after 1 substep x to 1e-6, v and C to 1e-5 of
               their max, J to 1e-6, slot for slot; ensemble mean and std
               of x after 100 to 5e-4, launches, the host checks; then the
               sharded runs alone, counted (p2g_grid and the prepadded g2p
               once per substep);
20. kernels:sharded2d  on those sharded states: p2g_grid's raw mode (fused
               at bench 1M, prepped 9 channels at stab1M, one call for all
               shards: the gather and the fold) against p2g_grid_plain and
               against fold_rows_halo of p2g_fused / p2g per shard (within
               1e-5, and whether bitwise equal: "equal_to_fold"), with its mass
               sum; the prepadded g2p against plain on the halo-synced
               grid; a ragged tent case at G = 2049 in 4 shards; CUDA-event
               times, plain times, bounds, p2g_grid's achieved bytes per
               second and two reruns bitwise equal to a first at the three
               shapes; halo_sync's time;
21. timing:sharded  ms per substep of the sharded and the single-device
               run, interleaved, median of 3 x 100 substeps (2D);
22. main:sharded migrate37  37^2, dt 4e-5, 8 shards, 3000 substeps against
               one device: slots migrate between shards, overflow 0, mass
               constant, ensemble within 5e-4; the CLI with --devices 4 on
               dam2d_flip98 (2 frames x 100 substeps);
23-25. main:sharded, kernels:sharded3d, timing:sharded (3D, one axis)
               slab 8M and stab3d-8M through Simulation(devices=4) against
               one device (50 and 20 substeps, the checks of phase 19),
               p2g3d_grid's raw mode (stress; prepped 11 channels) against
               plain on their states with its mass sum, reruns bitwise
               equal, and times, g2p3d on
               the halo-synced, grid-updated shard windows against plain
               (update mode; gather mode, 9-channel grid) with its times,
               halo_sync's time, ms per substep (3 x 10); the CLI with
               --devices 2 on dam3d;
26. main:colliders  the CLI on dam2d_obstacle and plow2d (2 frames x 200
               substeps) and dam3d_obstacle (64^3, 27,648 particles; 2
               frames x 100): launches (in 3D p2g3d_grid's collider mode
               once per substep), the host checks, and no particle deeper
               than 1.5 dx inside a collider at its final position;
27. main:obstacle8M  the 8M slab (phase 11's) cut by dam_break_obstacle_3d's
               static sphere, then by tests/test_colliders.py's rising
               sphere from t0 = 0.01 s, through Simulation, 2 frames x 10
               substeps each: launches, the grid nodes inside the collider,
               the host checks, the peak device memory;
28. kernels:colliders  p2g3d_grid's collider mode against plain on the
               obstacle8M state (both spheres) and on a ragged 32^3 case
               with a sphere, a sticky moving box and a halfspace spinner
               (stress, prepped 11 channels, tent): the finished grid per
               channel (mass-weighted; the empty nodes unweighted), the
               nodes whose inside flag differs (0), reruns bitwise equal,
               CUDA-event ms of the
               collider mode and of the same call without colliders, the
               bound;
29. timing:colliders  ms per substep of obstacle8M and slab 8M from the
               same particles, interleaved, median of 3 x 10 (with
               --profile, obstacle8M's device busy time and idle share);
30. main:general2d  the reference workload (dam2d: 8,450 particles, 105^2,
               dt 1e-6, float64) through the CLI's default path, 3 frames
               x 10,000 substeps: centre of mass, std x and front after
               each frame within 1e-5 of the golden statistics
               (tests/test_golden_reference.py), diagnostics.check, ms per
               substep; then elastic_drop and dam2d_obstacle on the general
               path (1 frame x 200): the host checks, no kernel launched;
31. main:general_vs_cpu  one general substep on the card (twice) and on
               the CPU from the same state: the reference scene after
               1,000 substeps (float64, every field within 1e-12 of its
               scale) and the stab1M switch set at 37^2 after 200 (float32,
               the carried fields within 1e-6);
32. main:general_vs_fast  bench 1M and stab1M from the same particles at
               t = 0: one substep of the general path against the fast
               path (kernels on), x within 1e-7 and v within 1e-4 slot for
               slot; ms per substep of both (median of 3 x 20) and their
               peak device memory;
33. main:general3d  the dam3d CLI on the general path (2 frames x 100), the
               host checks; slab 1M / 128^3 general against fast3d as in
               phase 32 (3 x 5 substeps timed);
34. main:mls88 the validation model at MLS88Config(): one float32 substep
               on the card against the CPU from warm-ups 0, 50 and 200
               (1e-5), 300 float64 substeps (5e-4), ms per substep; then
               the {"general": {...}} line;
35. main:plastic  snow and sand: the snow2d and sand2d CLIs on the fast
               and general paths (2 frames x 200 substeps: p2g and g2p once
               per substep and p2g_fused never on the fast path, no kernel
               on the general one; the host checks, Jp in [0.6, 20]); one
               general substep of each on the card twice and on the CPU
               after 200 (float64, 1e-12 of scale); snow2k and sand2k (the
               snow and sand scenes on 2049^2, 640,000 and 851,200
               particles, float32, dt 1e-6) through Simulation on the fast
               path, 2 frames x 100: launches, the host checks, peak memory,
               p2g and g2p against plain on the final state, p2g's reruns,
               CUDA-event times and bounds, ms per substep (3 x 20), one
               substep fast against general (x 1e-7, v 1e-4); two
               100-substep fast runs bitwise equal at sand2k and at bench
               1M; sanddrop3d (drop3d with a sand block, 2 x 10) with
               p2g3d_grid's prepped mode and g2p3d's gather mode against
               plain on its state, ms per substep (3 x 5), fast against
               general; the friction check of tests/test_sand.py:174-199
               (37^2, phi 15 and 45 degrees, 4000 substeps each on the
               fast path: the steeper pile is higher and narrower); then
               the {"plastic": {...}} line;
36. main:incompressible  CSF surface tension and the incompressible
               projection: the dam2d_incompressible CLI (8,450 particles,
               105^2; 2 frames x 100) on the fast path, the general path
               and --devices 4 (launches, the host checks, |J - 1| < 5e-4
               on the fast path, the CG's exit resid); one general
               substep card against CPU after 200 (float64, 1e-12 of
               scale); incomp1M (bench 1M with the projection): p2g_fused
               and g2p against plain on its state with times and bounds,
               ms per substep of the kernel and plain paths (3 x 20) and
               with the CG's flag read every iteration, the CG's exit
               resid, one substep against the general path, two
               100-substep runs bitwise equal, |J - 1|, peak memory, 4
               shards against one device (v and C within
               INCOMP_SHARD_TOL) with p2g_grid and the prepadded g2p
               against plain; incomp8M (the 8M slab with the projection:
               p2g3d with 7 channels + fold_rows0 + _grid_update): p2g3d
               and g2p3d against plain, reruns, ms per substep (3 x 5),
               peak memory, 4 shards against one device with p2g3d_grid's
               raw mode and g2p3d on the shard windows, general against
               fast at slab 1M; csf513 (the zero-gravity 2:1 drop on 513^2,
               102,152 particles) general against fast and ms per substep;
               the 41^2 drop on both paths (rounds within 1500 substeps,
               sigma 0 static over 300); dam2d_obstacle and dam3d_obstacle
               with the projection, fast against general after 1 and 200
               (100) substeps; then the {"incompressible": {...}} line;
37. main:general_determinism  the general path's fixed-order scatter
               (csrc/scatter.cu on a plan of one key a particle): two
               100-substep general runs bitwise equal at the 37^2 float32
               scene and at bench 1M (scatter and key-kernel launches
               counted, no transfer kernel); every scatter of one substep of the
               reference scene, bench 1M, slab 1M and a dense node (bench
               1M with 20,000 particles at one point) through the kernel
               bitwise the CPU's index_add_ on the same rows, and rerun
               equal; card against CPU after 200 float32 substeps at 37^2
               (v and C within CARRIED_FIXED); the scatter's kernel, plan
               (whole and its stable sort alone), plain and index_add_
               times by CUDA events (back to back, and on the device
               alone) and its bound at bench 1M, slab 1M and the dense
               node; the key kernel against its plain version;
38. main:checkpoint  2 frames uninterrupted against 1 frame, a checkpoint,
               a fresh Simulation restoring it and 1 frame: bench 1M fast
               (npz) and in 4 shards (a shard directory), the reference
               scene's general path in float64 (2 x 200) and slab 1M /
               128^3 on the fused branch and on relfloor3d's route:
               bitwise equal; write and read seconds and bytes;
39. main:two_axis  the dam3d CLI with --devices 2x2 (2 frames x 100,
               --checkpoint to a shard directory, then --resume); slab 8M,
               stab3d-8M and incomp8M on 2 x 2 windows against one device
               (sharded_against_single, the two-axis state read in the
               global order; incomp8M at INCOMP_SHARD_TOL with a stale
               axis-1 halo column in the CG that must read above it);
               launches of the 2 x 2 run alone; raw p2g3d_grid and g2p3d
               on the windows against plain with times and bounds; ms per
               substep of 2 x 2, 4 x 1 and one device at slab 8M,
               interleaved, median of 3, and halo_sync over both axes;
               the stabilized set on 2 x 2 windows at 32^3, 10 substeps
               card against CPU (v's largest difference, a reading);
40. kernels:halo1  p2g3d(halo1=True) against p2g3d_plain(halo1=True) on
               stab3d-8M's 2 x 2 windows and a ragged APIC case (per
               channel, mass sum), fold_rows0_halo of it per shard against
               raw p2g3d_grid, reruns bitwise equal, time and bound; then
               the {"port13": {...}} line;
41. kernels:fused2d  the fully fused 2D substep's kernel modes against
               their plain versions: p2g_grid(raw=False) at bench 1M
               (fused, slip), stab1M (prepped 9 channels, penalty) and on
               plow2d's state with its paddle (a kinematic collider) in
               the column (per channel, pad rows exactly 0, against the
               node pass of its own raw sums, reruns bitwise equal);
               g2p(update=True) unpadded, prepadded on p2g_grid's grid and
               on bench 1M's 4 shards (the dead slots' fill exact, reruns);
               times and bounds;
42. main:fused2d  bench 1M under MPM_P2G_GRID=1, MPM_FUSE2D_G2P=1 and
               both, set and restored inside the process: one substep
               against the default route (x 1e-6; v, C 1e-5 of their max;
               J 1e-6), 100 with launches and the host checks, F left
               alone by the fused G2P, reruns bitwise equal, ms per
               substep of the four routes in turn (median of 3 x 100), with
               --profile busy time, idle share and device kernels a
               substep; the dam2d_flip98 and plow2d CLIs with both
               variables (2 frames x 200); bench 1M in 4 shards with the
               fused G2P against one device (sharded_against_single);
43. kernels:stress3d  p2g3d(stress=...) against plain at slab 8M (linear)
               and on a ragged APIC Tait case, reruns bitwise equal,
               fold_rows0_halo of its halo1 output against raw p2g3d_grid
               (stress), time and bound; then the {"fused2d": {...}} line;
44. main:domain  the general path's slab domain (parallel/domain.py) on
               ranks of a gloo process group, every rank on this card
               (RANK_BACKEND; RankMesh stages the blocks through host
               memory): the reference scene (dam2d, float64) with the
               stabilized switch set, 5 substeps on 2 and on 4 ranks
               against one device slot for slot (x 1e-12, v 1e-10), two
               runs bitwise equal; the migration case (MIGRATE_THROWN, 100
               substeps on 4 ranks: active particles per rank change,
               dropped 0, count and mass exact, ensemble of x against one
               device within ENSEMBLE_TOL, reruns bitwise); two ranks asked
               for nccl on this one card must raise;
45. main:domain at scale  bench 1M and slab 1M / 128^3 (float32) on 4
               ranks: one substep against one device (x 1e-6, v and C 1e-5
               of their max), 3 x 20 (3 x 5) timed beside one device, the
               halo and migration ms and bytes per substep per rank, peak
               memory per rank (with --profile rank 0's device busy time);
46. main:domain_ext  on 4 ranks against one device: CSF on
               tests/test_surface_tension.py's drop (200 substeps, x
               1e-12), the projection on tests/test_projection.py's 33^2
               column (25 substeps, x 1e-8, v 1e-7), dam2d_obstacle (50
               substeps, x 1e-12, v 1e-10);
47. main:replicated  parallel/replicated.py on 4 ranks: 37^2 float64
               padded to a multiple of 12, 50 substeps against one device
               (x 1e-10, v 1e-8, J 1e-10); bench 1M one substep against one
               device and 3 x 20 timed with the all_reduce's ms and bytes;
               every rank's scatter launches in every run of 44-47 equal
               the scatters of its window, and no transfer kernel runs;
48. main:dryrun  mpm_flip98a_tpu_torch.dryrun.dryrun_multichip(4) (every
               multi-device leg on 4 gloo ranks, the 2 x 2 mesh among
               them); then the {"ranks": {...}} line;
49. main:fast_ranks bench1M  the 2D fast path one shard per rank
               (parallel/fast_domain.py on RankMesh, 4 gloo ranks on this
               card, one launch for phases 49-50) against SlabMesh(4) run
               by rank 0 from the same particles: each rank's rows of the
               layout bitwise, 1 substep slot for slot (the shard gates;
               every field bitwise equal expected), 100 (reported, the
               ensemble gate 5e-4), `p2g_grid` and `g2p` once a substep on
               every rank and no other kernel, overflow 0, 3 x 20 timed
               interleaved with SlabMesh(4) and one device (each rank's
               halo and migration ms, bytes and calls, peak memory); then
               `p2g_grid` raw and the prepadded `g2p` on each rank's own
               window (rank 1's origin 129 rows up) against plain, reruns
               bitwise, rank 1's times;
50. main:fast_ranks slab8M, slab8M 2x2, stab3d-8M, replicated  slab 8M on
               4 ranks (one axis) and on the 2 x 2 rank grid against
               SlabMesh of that shape: 1 substep by the shard gates, 20 by
               the ensemble gate, `p2g3d_grid` and `g2p3d` once a substep,
               3 x 10 timed with SlabMesh in turn; raw `p2g3d_grid` and
               `g2p3d` on each rank's window against plain (g2p3d's reruns
               bitwise); stab3d-8M (raw prepped 11 channels) 1 substep;
               fast_replicated at bench 1M against one device: 20
               substeps by the ensemble gate, `p2g_fused` and `g2p` once a
               substep, one all_reduce of the folded grid a substep with
               its bytes and ms, 3 x 10 timed; and with the stabilized
               set (stab1M: `p2g` prepped 9 channels, 7-channel `g2p`) 5
               substeps;
51. main:fast_ranks_cli  `--devices 4 --ranks --backend gloo` on
               dam2d_flip98 (2 frames x 100 substeps) and
               dam2d_incompressible (2 x 10), frames from rank 0 alone;
               dam3d `--devices 2x2
               --ranks` with a checkpoint after one frame, resumed on ranks
               and on SlabMesh(2, 2), each against the uninterrupted
               SlabMesh(2, 2) run bitwise; `--backend nccl` with 2
               ranks on this card must raise; then the {"fast_ranks": ...}
               line.

Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits with code 2 before doing anything.  The line before the
last lists every kernel with its launches, error, times and bound (p2g,
p2g_fused, p2g_grid and p2g3d with "rerun_bitwise_equal", p2g_fused and
p2g_grid with "achieved_bytes_per_s", p2g_grid with "equal_to_fold" and
"fold_max_abs_diff", p2g with its drop1M time; g2p
also with its 7-channel mode's under "ext_*", g2p and p2g with their tent
modes' under "tent_*", p2g3d_grid with its prepped 11-channel mode's under
"prepped_*", g2p3d with its 9-channel gather mode's under "gather_*", both
with the modes main:drop3d launched under "drop3d_*", the 3D kernels with
their tent modes' under "tent_*", p2g_grid with its prepped and tent modes'
under "prepped_*" and "tent_*", g2p with its prepadded mode's under
"prepadded_*", p2g3d_grid with its raw modes' under "raw_*" and
"raw_prepped_*", g2p3d on the 3D shard windows under "sharded_*" and
"sharded_gather_*", p2g3d_grid's collider mode under "colliders_*" with
"colliders_flips", its plans under "plans" and "rerun_bitwise_equal" (by
mode: stress, each prepped mode, colliders, raw on 4 shards and on 2 x 2
windows, rank 1's window; each checked);
p2g and g2p with main:plastic's modes under "snow2k_*" and "sand2k_*",
p2g3d_grid and g2p3d under "sanddrop3d_*"; main:incompressible's inputs
under "incomp1M_*" (p2g_fused, g2p), "incomp1Mx4_*" (p2g_grid, g2p),
"incomp8M_*" (p2g3d with 7 channels, g2p3d) and "incomp8Mx4_*"
(p2g3d_grid raw, g2p3d); p2g3d's halo1 mode under "halo1_*",
p2g3d_grid's raw mode and g2p3d on the two-axis windows under
"win2_<cell>_*", p2g_grid's non-raw mode under "finished_*" (with
"finished_prepped_*" and "finished_colliders_max_abs_err"), g2p's update
mode under "update_*" (with "update_prepadded_*" and "update_sharded_*"),
p2g3d's stress mode under "stress_*" (0 launches: no path runs it), and
"scatter", the general path's fixed-order scatter
(not a TPU kernel), with "equal_to_cpu", "rerun_bitwise_equal",
"plan_ms", "sort_ms", "kernel_plus_plan_ms", the device-only times
"*_device_ms" and its slab 1M and dense node numbers under "slab1M_*"
and "dense_*"; "scatter_keys", the plan's key kernel in csrc/scatter.cu;
and each rank's
launches in every run of phases 44-47 under "ranks_launches"); the fast
paths on ranks (phases 49-50): each rank's launches under "ranks_launches"
(p2g_grid, g2p at bench 1M; p2g3d_grid, g2p3d at slab 8M, with
"ranks_2x2_launches" and "ranks_stab3d_launches"), p2g_fused's and g2p's
under "replicated_ranks_launches", p2g's and g2p's at stab1M under
"replicated_stab1M_ranks_launches", and p2g_grid, g2p, p2g3d_grid and
g2p3d on a rank's own window under "ranks_*"; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Kernel-against-plain bound, per output channel, scaled by the channel's
# max: both sides sum each node's fp32 terms in another order (a fixed
# order of its own in each P2G kernel, atomics in the plain index_add_, FMA
# contraction in the kernels).
KERNEL_REL_TOL = 1e-5
POU_REL_TOL = 1e-6           # P2G mass channel vs total particle mass
BENCH = dict(                # bench.py:179-189, the 1M / 513^2 dam break
    dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
    num_particles_y=500, fluid_width=0.430, fluid_height=0.215,
    flip_blend=0.98,
)
# The stabilized switch set (reference config.py:18-29: F-bar, penalty EBC,
# pressure mixing 1.0), with BENCH's PIC transfer and FLIP blend.
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
SLAB_8M = dict(num_grids=256, particles_per_axis=(512, 512, 32))   # bench.py:198-205
SLAB_1M = dict(num_grids=128, particles_per_axis=(256, 256, 16))   # slab_3d()'s defaults
# elastic_drop_3d at two particles per cell per axis on 128^3: 3,518,251
# particles; dt by the fluid's sound speed (44.8 m/s: dx / c = 7.9e-5 s).
DROP_3D = dict(num_grids=128, fluid_particles=(230, 230, 64), block_particles=(51, 51, 51),
               dt=1e-5)
# main:relfloor3d against main:stab3d-8M after the same 20 substeps: the
# two routes differ in the floor's value and in the order of their sums.
# Read on an NVIDIA H100 80GB HBM3 at 700 W: x 1.9e-9, v 2.2e-6, J 1.2e-7;
# the bounds are about ten times that.
ROUTE_TOL = {"x": 2e-8, "v": 2e-5, "J": 1e-6}
# The sharded path's migration run: the JAX package's long collapse
# (tests/test_parallel_fast_domain.py:67-90: 37^2, dt 4e-5, 8 shards, 3000
# substeps), whose front crosses several slab edges.
MIGRATE = dict(num_grids=37, dt=4e-5, num_particles_x=16, num_particles_y=32, shards=8,
               substeps=3000)
TPU_KERNELS = {
    "p2g_fused": ("mpm_flip98a_tpu_torch/csrc/p2g.cu",
                  "mpm_flip98a_tpu/ops/pallas/transfer2d.py:412"),
    "g2p": ("mpm_flip98a_tpu_torch/csrc/g2p.cu",
            "mpm_flip98a_tpu/ops/pallas/transfer2d.py:843"),
    "p2g": ("mpm_flip98a_tpu_torch/csrc/p2g.cu",
            "mpm_flip98a_tpu/ops/pallas/transfer2d.py:304"),
    "p2g_grid": ("mpm_flip98a_tpu_torch/csrc/p2g.cu",
                 "mpm_flip98a_tpu/ops/pallas/transfer2d.py:597"),
    "p2g3d": ("mpm_flip98a_tpu_torch/csrc/p2g3d.cu",
              "mpm_flip98a_tpu/ops/pallas/transfer3d.py:349"),
    "p2g3d_grid": ("mpm_flip98a_tpu_torch/csrc/p2g3d_grid.cu",
                   "mpm_flip98a_tpu/ops/pallas/transfer3d.py:622"),
    "g2p3d": ("mpm_flip98a_tpu_torch/csrc/g2p3d.cu",
              "mpm_flip98a_tpu/ops/pallas/transfer3d.py:930"),
}
# Published peaks of one H100 SXM (NVIDIA's H100 datasheet): device
# memory rate and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def scaled_errors(got, want, axis, scale=None):
    """Per-channel (max abs err, that err / scale), scale defaulting to the
    channel's max |want|."""
    g = got.movedim(axis, 0).reshape(got.shape[axis], -1).double()
    w = want.movedim(axis, 0).reshape(want.shape[axis], -1).double()
    err = (g - w).abs().amax(dim=1)
    if scale is None:
        scale = w.abs().amax(dim=1)
    scale = torch.as_tensor(scale, dtype=torch.float64, device=err.device)
    return err.tolist(), (err / scale.clamp(min=1e-30)).tolist()


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time a call: the calls queued behind a sleep kernel, so the
    host's time between launches does not show (for calls of several
    launches whose device time is below their host time)."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# p2g3d_grid's tile plan at each timed shape and whether reruns of its
# stress mode at the slab 8M state are bitwise equal (kernels line); p2g,
# p2g_fused, p2g_grid and p2g3d sum in a fixed order: their reruns at every
# timed shape must be bitwise equal (rerun_equal), and a false fails the
# run.  p2g_grid against fold_rows_halo of the single-device kernel: all
# bitwise equal, and the largest difference (kernels line).
PLANS = {}
RERUNS = {}
FOLD = {"equal": True, "max_abs_diff": 0.0}
ACHIEVED = {}                # bytes per second of the timed kernels, by key


def rerun_equal(tag, name, call, card):
    """Two reruns of `call` bitwise equal to a first call; kept in RERUNS
    under `name` (all tags together) and printed."""
    first = call()
    same = all(torch.equal(first, call()) for _ in range(2))
    RERUNS[name] = RERUNS.get(name, True) and same
    say(f"[{tag}] {name}: two reruns bitwise equal to the first: {same}  [{card}]")
    check(same, f"{tag}: {name} reruns differ (its sums have a fixed order)")


def raw_mode_equal(tag, raw_out, call, card):
    """p2g3d_grid's raw mode at one shard against the `raw_out` of its
    non-raw mode on the same inputs: the same sums, bitwise."""
    same = torch.equal(raw_out, call())
    say(f"[{tag}] p2g3d_grid raw mode (one shard) bitwise equal to the non-raw mode's "
        f"raw_out: {same}  [{card}]")
    check(same, f"{tag}: p2g3d_grid's raw mode differs from the non-raw mode's raw sums")


def achieved(name, nbytes, ms, card):
    """Prints the bytes a kernel must move over its time, against the
    card's memory rate."""
    rate = nbytes / (ms * 1e-3)
    say(f"[achieved] {name}: {nbytes} bytes in + out in {ms:.4f} ms = {rate / 1e9:.1f} GB/s, "
        f"{rate / PEAK_BYTES_PER_S:.3f} of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s  [{card}]")
    return rate
# Peak device memory read on the same lines with the earlier p2g3d_grid,
# an atomic scatter into a raw buffer and a second launch for the nodes
# (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
PEAK_BEFORE_GIB = {"slab8M": 18.563, "obstacle8M static": 11.637,
                   "obstacle8M rising": 18.512}


def plan_line(tag, key, nch, g2, r0, r1, card, shards=1, apic=False):
    """Prints and keeps the plan p2g3d_grid's wrapper takes at these shapes
    (ops/cuda/transfer3d.plan_p2g3d_grid)."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    plan = tk3.plan_p2g3d_grid(nch, g2, r0, r1, shards, apic)
    PLANS[key] = {"tile": [tk3.NT, tk3.GRID3D_ROWS], "band": plan.band, "chunk": plan.cap,
                  "smem": plan.smem, "blocks": plan.blocks * plan.bands}
    say(f"[{tag}] p2g3d_grid plan at buckets {r0}x{r1}, G2 {g2}, {nch} raw channels, apic "
        f"{apic}, {shards} shard(s): tiles of {tk3.NT} x {tk3.GRID3D_ROWS} target pencils, z band "
        f"{plan.band} of {g2} columns, chunks of {plan.cap} records of {plan.rec} bytes, "
        f"{plan.smem} shared bytes a block, {plan.blocks * plan.bands} blocks in one launch  "
        f"[{card}]")


def bound(nbytes: float, flops: float):
    """(least ms on the card, what bounds it): the bytes the function must
    move at the memory rate against its float32 operations at the peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def compare_kernels(tag, sdata, pdata2, counts, grid4, args, dinv, card):
    """Kernel vs plain for both 2D transfers on one set of inputs; returns
    the worst absolute errors.  Plain calls here do not touch the counters."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    got = tk.p2g_fused(sdata, counts, **args)
    want = tk.p2g_fused_plain(sdata, counts, **args)
    err_p, rel_p = scaled_errors(got, want, axis=2)
    # Partition of unity: every slot in these inputs has all 9 taps inside.
    live = torch.arange(sdata.shape[2], device=sdata.device)[None, :] < counts[:, None]
    m_total = (sdata[:, 9].double() * live).sum().item()
    m_grid = got[:, :, 4].double().sum().item()
    pou = abs(m_grid - m_total) / m_total
    say(f"[kernels:{tag}] p2g_fused max_abs_err per channel {err_p} "
        f"scaled {['%.2e' % r for r in rel_p]} (tol {KERNEL_REL_TOL})  "
        f"mass sum rel err {pou:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel_p) <= KERNEL_REL_TOL, f"{tag}: p2g_fused disagrees with its plain version")
    check(pou <= POU_REL_TOL, f"{tag}: p2g_fused partition of unity")

    return max(err_p), compare_g2p(f"kernels:{tag}", pdata2, counts, grid4, args["dx"], dinv,
                                   False, card)


def compare_g2p(label, pdata2, counts, grid, dx, dinv, tent, card, prepadded=False):
    """`g2p` against `g2p_plain` (4 or 7 grid channels, B-spline or tent,
    an unpadded or a prepadded sharded grid); returns the worst absolute
    error."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    got = tk.g2p(pdata2, counts, grid, dx, dinv, tent, prepadded=prepadded)
    want = tk.g2p_plain(pdata2, counts, grid, dx, dinv, tent, prepadded=prepadded)
    # C sums +-(x_node - x_p) terms that cancel where the velocity field is
    # smooth, so its channels are scaled by one term's size, dinv dx |v|max.
    vmax = grid.movedim(-2, 0)[:2].reshape(2, -1).abs().amax(dim=1).double()
    scale = torch.cat([
        want[:, :4].abs().amax(dim=(0, 2)).double(),
        (dinv * dx * vmax).repeat_interleave(2),
        want[:, 8:].abs().amax(dim=(0, 2)).double(),
    ])
    err_g, rel_g = scaled_errors(got, want, axis=1, scale=scale)
    worst = int(np.argmax(rel_g))
    say(f"[{label}] g2p {grid.shape[-2]} grid channels, tent {tent}, prepadded {prepadded}: "
        f"max_abs_err per channel "
        f"{['%.3e' % e for e in err_g]}; worst channel {worst}: {rel_g[worst]:.2e} of its "
        f"scale (tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel_g) <= KERNEL_REL_TOL,
          f"{label}: g2p ({grid.shape[-2]} channels, tent {tent}) disagrees with its plain version")
    return max(err_g)


def ragged_inputs(device, seed=0):
    """Partly filled and empty buckets, particles on both column edges; all
    taps inside the grid so the mass must be conserved exactly."""
    rng = np.random.default_rng(seed)
    r, k, g = 64, 1024, 513
    counts = rng.integers(0, k + 1, r)
    counts[::7] = 0
    counts[3] = k
    rel = rng.integers(-1, 2, (r, k))
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, k)) * 0.999
    edge = rng.random((r, k))
    gx1 = np.where(edge < 0.2, 0.5 + rng.random((r, k)) * 0.01,        # left edge
          np.where(edge < 0.4, g - 2.0 + rng.random((r, k)) * 0.49,    # right edge
                   rng.uniform(0.5, g - 1.51, (r, k))))
    live = np.arange(k)[None, :] < counts[:, None]
    v = rng.normal(0.0, 1.0, (2, r, k))
    c = rng.normal(0.0, 50.0, (4, r, k))
    j = np.where(live, rng.uniform(0.98, 1.02, (r, k)), 1.0)
    mass = np.where(live, rng.uniform(1e-4, 2e-4, (r, k)), 0.0)
    vol0 = mass / 997.5
    sdata = np.stack([gx0, gx1, *v, *c, j, mass, vol0], axis=1).astype(np.float32)
    pdata2 = np.stack([gx0, gx1, live], axis=1).astype(np.float32)
    grid4 = rng.normal(0.0, 1.0, (r, 4, g)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device).contiguous()
    return t(sdata), t(pdata2), t(counts, torch.int32), t(grid4), g


def compare_prepped(tag, pdata, pdata2, counts, grid, args, dinv, card):
    """`p2g` against `p2g_plain` on prepped inputs (per channel, and its
    mass sum against the live particles' mass: every tap of these inputs
    lies inside the grid), then `g2p` on `grid` (7 channels and / or tent)
    against `g2p_plain`; returns the worst absolute errors of the two."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    nch = pdata.shape[1] - 8
    got = tk.p2g(pdata, counts, **args)
    want = tk.p2g_plain(pdata, counts, **args)
    err_p, rel_p = scaled_errors(got, want, axis=2)
    m_total = pdata[:, 12].double().sum().item()        # row 12: m, masked
    pou = abs(got[:, :, 4].double().sum().item() - m_total) / m_total
    worst = int(np.argmax(rel_p))
    say(f"[kernels:2dp {tag}] p2g {nch} channels, tent {args['tent']}, apic {args['apic']}, "
        f"G {args['g']}: max_abs_err per channel {['%.3e' % e for e in err_p]}; worst channel "
        f"{worst}: {err_p[worst]:.3e} / its max = {rel_p[worst]:.2e} (tol {KERNEL_REL_TOL}); "
        f"mass sum rel err {pou:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel_p) <= KERNEL_REL_TOL, f"{tag}: p2g disagrees with its plain version")
    check(pou <= POU_REL_TOL, f"{tag}: p2g partition of unity")

    return max(err_p), compare_g2p(f"kernels:2dp {tag}", pdata2, counts, grid, args["dx"],
                                   dinv, args["tent"], card)


def ragged_prepped(device, seed=1):
    """Ragged 9-channel tent inputs at G = 2049, whose (5, 9, G) slab is
    past the opt-in shared memory, so `p2g` runs in column bands; all taps
    inside the grid.  Also a random 7-channel grid for the tent `g2p`."""
    rng = np.random.default_rng(seed)
    r, k, g = 48, 1024, 2049
    counts = rng.integers(0, k + 1, r)
    counts[::7] = 0
    counts[3] = k
    rel = rng.integers(-1, 2, (r, k))
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, k)) * 0.999
    gx1 = rng.uniform(0.5, g - 1.51, (r, k))
    live = np.arange(k)[None, :] < counts[:, None]
    mass = rng.uniform(1e-4, 2e-4, (r, k))
    vals = np.concatenate([
        mass * rng.normal(0.0, 1.0, (2, r, k)), mass * rng.normal(0.0, 50.0, (4, r, k)),
        rng.normal(0.0, 1e-2, (4, r, k)), mass[None], rng.uniform(1e-7, 2e-7, (4, r, k)),
    ]) * live
    pdata = np.concatenate([gx0[None], gx1[None], vals]).transpose(1, 0, 2)
    pdata2 = np.stack([gx0, gx1, live], axis=1)
    grid = rng.normal(0.0, 1.0, (r, 7, g))
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device).contiguous()
    return t(pdata), t(pdata2), t(counts, torch.int32), t(grid), g


def host_checks(tag, sim, n0, p0_mass, card):
    """Finite, no overflow, constant mass, every particle inside the box."""
    from mpm_flip98a_tpu_torch.models import fast2d, fast3d

    dim = sim.cfg.dim
    h = (fast3d if dim == 3 else fast2d).to_host(sim.state)
    x = np.stack([h[f"x{a}"] for a in range(dim)], -1)
    cfg = sim.cfg
    names = [f"x{a}" for a in range(dim)] + [f"v{a}" for a in range(dim)] + ["J"]
    finite = all(np.isfinite(h[n]).all() for n in names)
    overflow = int(sim.state.overflow.sum())    # one count per shard when sharded
    mass = float(h["mass"].astype(np.float64).sum())
    inside = bool(((x > -cfg.dx) & (x < cfg.domain_length + cfg.dx)).all())
    say(f"[main:{tag}] particles {x.shape[0]} finite {finite} overflow {overflow} "
        f"mass {mass!r} (initial {p0_mass!r}) inside box {inside} "
        f"rebuckets {sim.stats.rebuckets} host reads {sim.stats.host_reads}  [{card}]")
    check(finite, f"{tag}: non-finite state")
    check(overflow == 0, f"{tag}: bucket overflow")
    check(x.shape[0] == n0, f"{tag}: {x.shape[0]} particles, expected {n0}")
    check(abs(mass - p0_mass) <= 1e-9 * p0_mass, f"{tag}: mass changed")
    check(inside, f"{tag}: particle outside the box")


def frame_io_available() -> bool:
    from mpm_flip98a_tpu_torch.utils import native_io

    if native_io.available():
        return True
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def time_run(mod, b, scene, spec, n_sub, plain):
    """Seconds for `run` of n_sub substeps (host clock around work that
    ends in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.run(b, scene, spec, n_sub, plain=plain)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def time_substeps_no_check(step, b, n_sub, reps):
    """The same substeps without the per-substep margin read (state is
    discarded): the difference to `time_run` is the host read's cost."""
    times = []
    for _ in range(reps):
        s = b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_sub):
            s = step(s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def time_paths(label, mod, b, scene, spec, step, n_part, stencil, n_sub, reps, card,
               plain=True):
    """Kernel path (and plain path) by `run`, interleaved, then the kernel
    path without the margin read; returns the kernel path's median."""
    paths = (False, True) if plain else (False,)
    runs = {p: [] for p in paths}
    for p in paths:          # warm-up
        time_run(mod, b, scene, spec, 3, p)
    for _ in range(reps):    # interleaved: kernel, plain, kernel, plain ...
        for p in paths:
            runs[p].append(time_run(mod, b, scene, spec, n_sub, p))
    no_check = time_substeps_no_check(step, b, n_sub, reps)
    ops = n_part * stencil * 2 * n_sub
    rows = [("kernel path", runs[False])]
    if plain:
        rows.append(("plain path", runs[True]))
    rows.append(("kernel path, no margin read", no_check))
    for name, ts in rows:
        med = float(np.median(ts))
        say(f"[timing:{label}] {name}: {1e3 * med / n_sub:.4f} ms/substep "
            f"(median of {reps} x {n_sub}; runs {[round(1e3 * t / n_sub, 4) for t in ts]} "
            f"ms/substep), {ops / med:.4e} transfer ops/s  [{card}]")
    read_ms = 1e3 * (np.median(runs[False]) - np.median(no_check)) / n_sub
    say(f"[timing:{label}] per-substep margin read costs {read_ms:.4f} ms/substep  [{card}]")
    return float(np.median(runs[False])) / n_sub


def profile_window(path, mod, b, scene, spec, n_sub, wall_ms, tag, card):
    return profile_calls(path, lambda n: mod.run(b, scene, spec, n), n_sub, wall_ms, tag, card)


def profile_calls(path, run_n, n_sub, wall_ms, tag, card):
    """torch.profiler over `run_n(n_sub)` (after `run_n(2)`): the table by
    device time to `path`, the device busy time per substep and the idle
    share against the unprofiled `wall_ms` per substep."""
    from torch.profiler import ProfilerActivity, profile

    run_n(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_n(n_sub)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as f:
        f.write(f"{card}\n{table}\n")
    # Device busy time: the kernels' own time (device-side events only).
    busy_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in events
        if str(e.device_type).endswith("CUDA")
    ) / 1e3 / n_sub
    say(f"[timing:{tag}] profile written to {path}: device busy "
        f"{busy_ms:.4f} ms/substep against {wall_ms:.4f} ms/substep unprofiled "
        f"(idle share {1.0 - busy_ms / wall_ms:.3f})  [{card}]")
    return busy_ms


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------


def ragged_inputs3d(device, seed=0, r=64, k=256, g=64):
    """Ragged pencils: empty, full and partly filled, live slots outside
    the +-1 margin on both axes, z taps past both grid edges."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k + 1, (r, r))
    counts[::7, ::5] = 0
    counts[3, 3] = k
    rel0 = rng.choice([-1, 0, 0, 1, 2], size=(r, r, k))
    rel1 = rng.choice([-1, 0, 0, 1, -2], size=(r, r, k))
    gx0 = np.arange(r)[:, None, None] + rel0 + 0.5 + rng.random((r, r, k))
    gx1 = np.arange(r)[None, :, None] + rel1 + 0.5 + rng.random((r, r, k))
    gx2 = rng.uniform(-1.0, g + 1.0, (r, r, k))
    live = np.arange(k) < counts[..., None]
    v = rng.normal(0.0, 1.0, (3, r, r, k))
    c = rng.normal(0.0, 5.0, (9, r, r, k))
    j = np.where(live, rng.uniform(0.98, 1.02, (r, r, k)), 1.0)
    mass = np.where(live, rng.uniform(1e-4, 2e-4, (r, r, k)), 0.0)
    vol0 = mass / 997.5
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    planes = tuple(t(a) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0))
    dx = 0.4375 / (g - 5)
    state = (*planes[3:6], planes[15], *((p - 2.0) * dx for p in planes[:3]))
    counts = torch.as_tensor(counts.reshape(-1), dtype=torch.int32, device=device)
    return planes, t(live), counts, state, g, dx


def compare_kernels3d(tag, planes, counts, mask, state, kw, dinv, card):
    """Kernel vs plain for both 3D transfers on one set of inputs; returns
    the worst absolute errors of the two outputs (grid, G2P output)."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    r0, r1, _ = planes[0].shape
    g2, dx = kw["g2"], kw["dx"]
    args = {n: v for n, v in kw.items() if n != "alpha"}
    scatter = {n: args[n] for n in ("apic", "stress", "kb", "mu", "gamma", "fa")}
    raw = torch.empty((r0 + 4, r1 + 4, tk3.P2G_CH, g2), device=counts.device)
    got = tk3.p2g3d_grid(planes, counts, r1, raw_out=raw, **args)
    raw_plain = tk3.p2g3d_raw_plain(planes, counts, g2, dx, **scatter)
    want = tk3.p2g3d_grid_plain(planes, counts, r1, **args)
    err_r, rel_r = scaled_errors(raw, raw_plain, axis=2)
    m_expect = expected_sum3d(planes[:3], planes[16], counts, g2, False)
    pou = abs(float(raw[:, :, 6].double().sum()) - m_expect) / m_expect
    # The finished grid's velocities are raw sums over the nodal mass: their
    # error is weighted by that mass and scaled by the raw sum's max.
    m = raw_plain[:, :, 6:7].double()
    mom_err = ((got - want).double().abs() * m).amax(dim=(0, 1, 3))
    mom_max = raw_plain[:, :, [3, 4, 5, 0, 1, 2]].double().abs().amax(dim=(0, 1, 3))
    rel_m = (mom_err / mom_max.clamp(min=1e-30)).tolist()
    err_grid = float((got - want).abs().max())
    pads_zero = not bool(got[0].any()) and not bool(got[r0 + 1:].any())
    say(f"[kernels:{tag}] p2g3d_grid raw sums max_abs_err per channel {err_r} "
        f"scaled {['%.2e' % r for r in rel_r]} (tol {KERNEL_REL_TOL}); finished grid "
        f"max_abs_err {err_grid:.3e}, mass-weighted scaled {['%.2e' % r for r in rel_m]} "
        f"(tol {KERNEL_REL_TOL}); mass sum rel err {pou:.3e} (tol {POU_REL_TOL}); "
        f"axis-0 pads zero {pads_zero}  [{card}]")
    check(max(rel_r) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid raw sums disagree with plain")
    check(max(rel_m) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid grid disagrees with plain")
    check(pou <= POU_REL_TOL, f"{tag}: p2g3d_grid partition of unity")
    check(pads_zero, f"{tag}: p2g3d_grid axis-0 pad rows not zero")
    del raw_plain, want
    raw_mode_equal(f"kernels:{tag}", raw, lambda: tk3.p2g3d_grid(
        planes, counts, r1, g2, dx, raw=True, **scatter)[0], card)
    rerun_equal(f"kernels:{tag}", "p2g3d_grid_stress",
                lambda: tk3.p2g3d_grid(planes, counts, r1, **args), card)
    del raw

    gxs = planes[:3]
    g2p_args = (*gxs, mask, counts, got, dx, dinv, state, kw["alpha"], kw["dt"])
    got_u = tk3.g2p3d(*g2p_args)
    want_u = tk3.g2p3d_plain(*g2p_args)
    # x and J at their scale, v per channel, C by one term's size.
    c_unit = dinv * dx * float(got[:, :, :3].abs().max())
    scale = want_u.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = c_unit
    scale[15] = max(float(scale[15]), 1.0)
    err_u, rel_u = scaled_errors(got_u, want_u, axis=2, scale=scale)
    say(f"[kernels:{tag}] g2p3d max_abs_err per channel {['%.2e' % e for e in err_u]} "
        f"scaled {['%.2e' % r for r in rel_u]} (tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel_u) <= KERNEL_REL_TOL, f"{tag}: g2p3d disagrees with its plain version")
    return err_grid, max(err_u), got


def ragged_prepped3d(device, apic, ext, seed=2, **size):
    """Prepped planes on ragged pencils: empty, full and partly filled,
    live slots outside the +-1 margin on both axes, slots whose taps leave
    the grid on axis 1 (dropped by p2g3d, kept in p2g3d_grid's pad rows)
    and along z.  Returns (fields, mask, counts, g, dx)."""
    planes, live, counts, _, g, dx = ragged_inputs3d(device, seed, **size)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda scale: (torch.randn(live.shape, generator=gen) * scale).to(device)
    mass, vol0 = planes[16], planes[17]
    fields = [*planes[:3], *(mass * v for v in planes[3:6])]
    if apic:
        fields += [mass * c for c in planes[6:15]]
    fields += [rand(1e-2) * mass for _ in range(9)]
    fields.append(mass)
    if ext:
        fields += [vol0 * planes[15], vol0, vol0 * rand(2e3), vol0 * rand(5.0)]
    return tuple(f.contiguous() for f in fields), live, counts, g, dx


def expected_sum3d(gxs, plane, counts, g2, tent, g1=None):
    """float64 sum a P2G channel of pure weights must hold: the live
    in-margin slots' `plane` times the share of their z taps inside
    [0, g2) and, for p2g3d (`g1` given), of their axis-1 taps in [0, g1).
    The tap weights are written out here, so a wrong weight in the port
    does not cancel against itself."""
    r0, r1, k = gxs[0].shape
    dev = gxs[0].device
    gx0, gx1, gx2 = (p.double() for p in gxs)
    live = torch.arange(k, device=dev) < counts.view(r0, r1, 1)
    ok = (
        ((torch.floor(gx0 - 0.5) - torch.arange(r0, device=dev)[:, None, None]).abs() <= 1)
        & ((torch.floor(gx1 - 0.5) - torch.arange(r1, device=dev)[None, :, None]).abs() <= 1)
        & live
    )

    def share(gx, n):
        base = torch.floor(gx - 0.5)
        fx = gx - base                                   # in [0.5, 1.5)
        if tent:    # the hat (1 - |d|)+ at d = fx, fx - 1, fx - 2
            taps = ((1.0 - fx).clamp(min=0.0), 1.0 - (fx - 1.0).abs(), (fx - 1.0).clamp(min=0.0))
        else:       # the quadratic B-spline
            taps = (0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2)
        out = torch.zeros_like(gx)
        for j, w in enumerate(taps):
            out += w * ((base + j >= 0) & (base + j < n))
        return out

    total = share(gx2, g2) if g1 is None else share(gx2, g2) * share(gx1, g1)
    return float((plane.double() * total * ok).sum())


def compare_prepped3d(tag, fields, counts, mask, mode, node, g2, dx, card):
    """Kernel vs plain for the prepped 3D transfers on one set of inputs:
    p2g3d, p2g3d_grid's prepped mode (raw sums, finished grid), the fold of
    p2g3d against the interior of those raw sums, and the gather-mode
    g2p3d on that grid.  Returns the worst absolute errors (p2g3d,
    p2g3d_grid's grid, g2p3d) and the finished grid."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    apic, ext, tent = mode
    r0, r1, _ = fields[0].shape
    nch = tk3.P2G_CH_EXT if ext else tk3.P2G_CH
    label = f"kernels:3dp {tag}] {nch} channels, apic {apic}, tent {tent}"
    m_plane = fields[tk3.n_prepped(apic, False) - 1]

    got = tk3.p2g3d(fields, counts, r1, g2, dx, apic=apic, ext=ext, tent=tent)
    want = tk3.p2g3d_plain(fields, counts, r1, g2, dx, apic, ext, tent)
    err_e, rel_e = scaled_errors(got, want, axis=3)
    m_expect = expected_sum3d(fields[:3], m_plane, counts, g2, tent, g1=r1)
    pou_e = abs(float(got[:, :, :, 6].double().sum()) - m_expect) / m_expect
    del want
    worst = int(np.argmax(rel_e))
    say(f"[{label}: p2g3d max_abs_err per channel {['%.3e' % e for e in err_e]}; worst channel "
        f"{worst}: {rel_e[worst]:.2e} of its max (tol {KERNEL_REL_TOL}); mass sum rel err "
        f"{pou_e:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel_e) <= KERNEL_REL_TOL, f"{tag}: p2g3d disagrees with its plain version")
    check(pou_e <= POU_REL_TOL, f"{tag}: p2g3d partition of unity")
    folded = tk3.fold_rows0(got)
    del got

    raw = torch.empty((r0 + 4, r1 + 4, nch, g2), device=counts.device)
    grid = tk3.p2g3d_grid(fields, counts, r1, g2, dx, apic=apic, tent=tent, ext=ext,
                          raw_out=raw, **node)
    # The two routes' sums agree on the interior rows (the JAX package's
    # own cross-check, tests/test_p2g_grid.py:168-212).
    err_f, rel_f = scaled_errors(folded, raw[1 : r0 + 1, 1 : r1 + 1], axis=2)
    fold_equal = torch.equal(folded, raw[1 : r0 + 1, 1 : r1 + 1])
    del folded
    raw_plain = tk3.p2g3d_raw_plain(fields, counts, g2, dx, apic=apic, tent=tent, ext=ext)
    want = tk3.grid_update3d_plain(raw_plain, r0, ext=ext, **node)
    err_r, rel_r = scaled_errors(raw, raw_plain, axis=2)
    m_expect = expected_sum3d(fields[:3], m_plane, counts, g2, tent)
    pou = abs(float(raw[:, :, 6].double().sum()) - m_expect) / m_expect
    # Velocities are sums over the nodal mass and the averages sums over
    # the nodal volume: their error is weighted by that sum and scaled by
    # the raw channel's max.
    diff = (grid - want).double().abs()
    weight = [raw_plain[:, :, 6:7].double()] * 6 + [raw_plain[:, :, 8:9].double()] * (3 * ext)
    tops = raw_plain[:, :, [3, 4, 5, 0, 1, 2] + [7, 9, 10] * ext].double().abs().amax(dim=(0, 1, 3))
    rel_g = [
        float((diff[:, :, ch : ch + 1] * weight[ch]).max() / tops[ch].clamp(min=1e-30))
        for ch in range(grid.shape[2])
    ]
    err_grid = float(diff.max())
    pads_zero = not bool(grid[0].any()) and not bool(grid[r0 + 1:].any())
    say(f"[{label}: p2g3d_grid raw sums worst channel {max(rel_r):.2e} of its max, finished "
        f"grid max_abs_err {err_grid:.3e}, weighted and scaled {['%.2e' % r for r in rel_g]} "
        f"(tol {KERNEL_REL_TOL}); mass sum rel err {pou:.3e} (tol {POU_REL_TOL}); axis-0 pads "
        f"zero {pads_zero}; fold_rows0(p2g3d) vs the interior raw sums worst channel "
        f"{max(rel_f):.2e} of its max, bitwise equal {fold_equal} (a reading: the two "
        f"routes sum in different orders)  [{card}]")
    check(max(rel_r) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid raw sums disagree with plain")
    check(max(rel_g) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid grid disagrees with plain")
    check(pou <= POU_REL_TOL, f"{tag}: p2g3d_grid partition of unity")
    check(pads_zero, f"{tag}: p2g3d_grid axis-0 pad rows not zero")
    check(max(rel_f) <= KERNEL_REL_TOL, f"{tag}: fold_rows0(p2g3d) disagrees with p2g3d_grid")
    del raw_plain, want, diff, weight
    raw_mode_equal(f"kernels:3dp {tag}", raw, lambda: tk3.p2g3d_grid(
        fields, counts, r1, g2, dx, apic=apic, tent=tent, ext=ext, raw=True)[0], card)
    del raw
    mode_name = f"p2g3d_grid_{'apic' if apic else 'pic'}{nch}{'_tent' if tent else ''}"
    rerun_equal(f"kernels:3dp {tag}", mode_name, lambda: tk3.p2g3d_grid(
        fields, counts, r1, g2, dx, apic=apic, tent=tent, ext=ext, **node), card)

    dinv = 1.0 if tent else 4.0 / dx**2
    g2p_args = (*fields[:3], mask, counts, grid, dx, dinv)
    got_g = tk3.g2p3d(*g2p_args, tent=tent)
    want_g = tk3.g2p3d_plain(*g2p_args, tent=tent)
    scale = want_g.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = dinv * dx * float(grid[:, :, :3].abs().max())    # C: one term's size
    if ext:
        scale[15] = max(float(scale[15]), 1.0)                      # Jbar near 1
    err_u, rel_u = scaled_errors(got_g, want_g, axis=2, scale=scale)
    worst = int(np.argmax(rel_u))
    say(f"[{label}: g2p3d gather mode, {grid.shape[2]} grid channels: max_abs_err per channel "
        f"{['%.2e' % e for e in err_u]}; worst channel {worst}: {rel_u[worst]:.2e} of its scale "
        f"(tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel_u) <= KERNEL_REL_TOL, f"{tag}: g2p3d gather mode disagrees with plain")
    return max(err_e), err_grid, max(err_u), grid


def prepped3d_phases(dev, card, profile_dir, p8, scene_fluid, err, kernel_ms, plain_ms,
                     bounds, launches, t_start):
    """Phases 14-18: the 3D prepped branch (stab3d-8M, relfloor3d, drop3d)."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    reset_all, counts_now = reset_counts, kernel_counts
    tmp = tempfile.gettempdir()

    # ---- 14. main:stab3d-8M ------------------------------------------------
    scene_stab = dataclasses.replace(
        scene_fluid, cfg=dataclasses.replace(scene_fluid.cfg, **STAB))
    mass8 = float(p8.mass.to(torch.float32).double().sum())
    n_frames, n_sub = 2, 10
    sims = {}
    for tag, scene, ran, idle in (
        ("stab3d-8M", scene_stab, ("p2g3d_grid", "g2p3d"), "p2g3d"),
        ("relfloor3d", dataclasses.replace(scene_stab, mass_floor=0.0), ("p2g3d", "g2p3d"),
         "p2g3d_grid"),
    ):
        check(not fast3d.uses_fused(scene), f"{tag} took the fused branch")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        sim = driver.Simulation(p8, scene, path="fast", out_dir=tmp, device=dev)
        reset_all()
        t0 = time.perf_counter()
        sim.run(n_frames, n_sub, gif=False, verbose=False, write_frames=False)
        torch.cuda.synchronize()
        got = counts_now()
        peak = torch.cuda.max_memory_allocated()
        say(f"[main:{tag}] {p8.n} particles, grid {scene.cfg.num_grids}^3, buckets "
            f"{tuple(sim.state.shape)}, mass floor {scene.mass_floor!r}; Simulation {n_frames} "
            f"frames x {n_sub} substeps in {time.perf_counter() - t0:.2f} s, launches {got}; "
            f"peak device memory {peak} bytes = {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
            f"of it held by earlier phases)  [{card}]")
        for name in ran:
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{tag}: {name} launched {got[name]} times for {n_frames * n_sub} substeps")
        check(got[idle] == 0, f"{tag}: {idle} ran")
        check(got["p2g_fused"] == got["p2g"] == got["g2p"] == 0, f"{tag}: a 2D kernel ran")
        host_checks(tag, sim, p8.n, mass8, card)
        jh = fast3d.to_host(sim.state)["J"]
        say(f"[main:{tag}] J range [{float(jh.min())!r}, {float(jh.max())!r}] "
            f"(bound |J - 1| < 0.1)")
        check(float(np.abs(jh - 1.0).max()) < 0.1, f"{tag}: J left [0.9, 1.1]")
        sims[tag] = sim
        for name in ran:
            launches[f"{name} on {tag}"] = got[name]
    launches["p2g3d"] = launches["p2g3d on relfloor3d"]

    # ---- 15. relfloor3d against stab3d-8M ------------------------------------
    a, b_rel = sims["stab3d-8M"].state, sims["relfloor3d"].state
    check(a.shape == b_rel.shape and bool((a.mask == b_rel.mask).all()),
          "relfloor3d: the two routes left different slot layouts")
    worst = {
        key: max(float((getattr(a, n) - getattr(b_rel, n)).abs().max()) for n in names)
        for key, names in (("x", ("x0", "x1", "x2")), ("v", ("v0", "v1", "v2")), ("J", ("J",)))
    }
    say(f"[main:relfloor3d] against stab3d-8M after {n_frames * n_sub} substeps from the same "
        f"state: max abs difference {worst} (tol {ROUTE_TOL})  [{card}]")
    for key, tol in ROUTE_TOL.items():
        check(worst[key] <= tol, f"relfloor3d: {key} differs from stab3d-8M by {worst[key]}")
    del a, b_rel

    # ---- 16. kernels:3dp -------------------------------------------------------
    sim = sims["stab3d-8M"]
    cfg8, spec8 = scene_stab.cfg, sim.spec
    args = fast3d.p2g_args(scene_stab)
    mode = (args["apic"], args["ext"], args["tent"])
    node = {n: args[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")}
    g3, dx3 = args["g2"], args["dx"]
    fields = fast3d.prepped_fields(sim.state, scene_stab, spec8)
    counts = fast3d.pencil_counts(sim.state)
    mask = sim.state.mask.view(spec8.rows0, spec8.rows1, spec8.capacity)
    err["p2g3d"], err["p2g3d_grid_prepped"], err["g2p3d_gather"], grid9 = compare_prepped3d(
        "stab3d-8M", fields, counts, mask, mode, node, g3, dx3, card)
    for rmode, key in (((True, False, False), None), ((False, True, True), "tent")):
        rf, rmask, rcounts, rg, rdx = ragged_prepped3d(dev, rmode[0], rmode[1])
        rnode = {**node, "hi": rg - 3}
        e_p, e_g, e_u, _ = compare_prepped3d("ragged", rf, rcounts, rmask, rmode, rnode, rg,
                                             rdx, card)
        if key:
            err["p2g3d_tent"], err["p2g3d_grid_tent"], err["g2p3d_tent"] = e_p, e_g, e_u
        del rf, rmask, rcounts
    torch.cuda.empty_cache()

    r0, r1, k3 = mask.shape
    live3 = int(counts.sum())
    n_in = len(fields)
    nch, gch = tk3.P2G_CH_EXT, tk3.G2P_CH_EXT
    dinv3 = float(4.0 * cfg8.inv_dx * cfg8.inv_dx)
    p2g3d_kw = dict(apic=mode[0], ext=mode[1])
    g2p_in = (*fields[:3], mask, counts, grid9, dx3)
    calls = {
        "p2g3d": lambda tent=False: tk3.p2g3d(fields, counts, r1, g3, dx3, tent=tent, **p2g3d_kw),
        "p2g3d_grid_prepped": lambda tent=False: tk3.p2g3d_grid(
            fields, counts, r1, g3, dx3, tent=tent, **p2g3d_kw, **node),
        "g2p3d_gather": lambda tent=False: tk3.g2p3d(
            *g2p_in, 1.0 if tent else dinv3, tent=tent),
    }
    plains = {
        "p2g3d": lambda: tk3.p2g3d_plain(fields, counts, r1, g3, dx3, *mode),
        "p2g3d_grid_prepped": lambda: tk3.p2g3d_grid_plain(
            fields, counts, r1, g3, dx3, **p2g3d_kw, **node),
        "g2p3d_gather": lambda: tk3.g2p3d_plain(*g2p_in, dinv3),
    }
    tent_keys = {"p2g3d": "p2g3d_tent", "p2g3d_grid_prepped": "p2g3d_grid_tent",
                 "g2p3d_gather": "g2p3d_tent"}
    nodes = (r0 + 4) * (r1 + 4) * g3
    p2g3d_bytes = 4 * (n_in * live3 + r0 * r1 + 5 * nch * r0 * r1 * g3)
    bounds.update({
        # live slots' prepped planes + counts in; the expanded (R0, 5, G1,
        # 11, G2) sums out; 27 taps x 11 channels of multiply-adds a live slot.
        "p2g3d": bound(p2g3d_bytes, live3 * 27 * nch * 2),
        # the same planes in; the finished 9-channel padded grid out.
        "p2g3d_grid_prepped": bound(4 * (n_in * live3 + r0 * r1 + gch * nodes),
                                    live3 * 27 * nch * 2),
        # live slots' [gx (3), mask] + counts + the 9-channel grid in; every
        # slot's 18 channels out; 27 taps x (9 + 9) sums per live slot.
        "g2p3d_gather": bound(4 * (4 * live3 + r0 * r1 + gch * nodes + 18 * r0 * r1 * k3),
                              live3 * 27 * 18 * 2),
    })
    for name, call in calls.items():
        kernel_ms[name] = cuda_ms(call, reps=10, warm=2)
        plain_ms[name] = cuda_ms(plains[name], reps=2, warm=1)
        tent_key = tent_keys[name]
        kernel_ms[tent_key] = cuda_ms(lambda call=call: call(tent=True), reps=10, warm=2)
        say(f"[kernels:3dp] {name} at the stab3d-8M shapes ({n_in} planes, buckets "
            f"{r0}x{r1}x{k3}, {live3} live): kernel {kernel_ms[name]:.4f} ms, with tent taps "
            f"{kernel_ms[tent_key]:.4f} ms (CUDA events, 10 calls), plain {plain_ms[name]:.4f} "
            f"ms (2 calls), bound {bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")
    plan_line("kernels:3dp", "prepped", nch, g3, r0, r1, card)
    plan3 = tk3.plan_p2g3d(nch, g3, k3, mode[0])
    say(f"[kernels:3dp] p2g3d plan at buckets {r0}x{r1}x{k3}, G2 {g3}, {nch} channels: z band "
        f"{plan3.band}, {plan3.cap} records of {plan3.rec} bytes a window, {plan3.smem} shared "
        f"bytes a block, {r0 * r1 * plan3.bands} blocks  [{card}]")
    achieved("p2g3d at the stab3d-8M shapes", p2g3d_bytes, kernel_ms["p2g3d"], card)
    rerun_equal("kernels:3dp stab3d-8M", "p2g3d", calls["p2g3d"], card)
    rerun_equal("kernels:3dp stab3d-8M tent", "p2g3d", lambda: calls["p2g3d"](tent=True), card)
    rel_sim = sims["relfloor3d"]
    rel_fields = fast3d.prepped_fields(rel_sim.state, rel_sim.scene, rel_sim.spec)
    rel_counts = fast3d.pencil_counts(rel_sim.state)
    rerun_equal("kernels:3dp relfloor3d", "p2g3d", lambda: tk3.p2g3d(
        rel_fields, rel_counts, r1, g3, dx3, **p2g3d_kw), card)
    del rel_fields, rel_counts
    expanded = calls["p2g3d"]()
    fold_ms = cuda_ms(lambda: tk3.fold_rows0(expanded), reps=5, warm=1)
    gs = tk3.fold_rows0(expanded)
    del expanded
    rel_scene = sims["relfloor3d"].scene
    upd_ms = cuda_ms(lambda: fast3d._grid_update(gs, rel_scene), reps=5, warm=1)
    prep_ms = cuda_ms(lambda: fast3d.prepped_fields(sim.state, scene_stab, spec8), reps=5, warm=1)
    say(f"[kernels:3dp] plain torch beside the kernels at the stab3d-8M shapes: fold_rows0 "
        f"{fold_ms:.4f} ms, _grid_update {upd_ms:.4f} ms, prepped_fields (the stress prep) "
        f"{prep_ms:.4f} ms (CUDA events, 5 calls)  [{card}]")
    del fields, counts, mask, grid9, g2p_in, calls, plains, gs
    torch.cuda.empty_cache()

    # ---- 18a. timing:3dp at 8M -------------------------------------------------
    for tag in ("stab3d-8M", "relfloor3d"):
        sim = sims[tag]
        step = lambda s, sim=sim: fast3d.substep(s, sim.scene, sim.spec)
        wall = time_paths(f"3dp {tag}", fast3d, sim.state, sim.scene, sim.spec, step, p8.n, 27,
                          10, 3, card, plain=False)
        if profile_dir:
            profile_window(os.path.join(profile_dir, f"profile_{tag}_3_substeps.txt"),
                           fast3d, sim.state, sim.scene, sim.spec, 3, 1e3 * wall, f"3dp {tag}",
                           card)
    del sims, sim
    torch.cuda.empty_cache()

    # ---- 17. main:drop3d ---------------------------------------------------------
    t0 = time.perf_counter()
    p_d, scene_d = scenes.elastic_drop_3d(**DROP_3D)
    mass_d = float(p_d.mass.to(torch.float32).double().sum())
    sim_d = driver.Simulation(p_d, scene_d, path="fast", out_dir=tmp, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    reset_all()
    t0 = time.perf_counter()
    sim_d.run(n_frames, n_sub, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = counts_now()
    say(f"[main:drop3d] elastic_drop_3d {DROP_3D}: {p_d.n} particles, materials "
        f"{scene_d.materials_present}, transfer {scene_d.cfg.transfer}, buckets "
        f"{tuple(sim_d.state.shape)}; built in {t_build:.2f} s; Simulation {n_frames} frames x "
        f"{n_sub} substeps in {time.perf_counter() - t0:.2f} s, launches {got}  [{card}]")
    for name in ("p2g3d_grid", "g2p3d"):
        check(got[name] == n_frames * n_sub, f"drop3d: {name} launched {got[name]} times")
    check(got["p2g3d"] == 0, "drop3d: p2g3d ran with an absolute mass floor")
    check(len(scene_d.materials_present) == 2, "drop3d: expected two materials")
    host_checks("drop3d", sim_d, p_d.n, mass_d, card)
    moved = bool((sim_d.state.F22 != 1.0).any())
    check(moved, "drop3d: the block's F was never updated")
    for name in ("p2g3d_grid", "g2p3d"):
        launches[f"{name} on drop3d"] = got[name]

    # ---- 17b. kernels:3dp at drop3d's shapes ---------------------------------------
    # The modes main:drop3d launched: p2g3d_grid's prepped mode on 25 APIC
    # planes (7 raw channels) and g2p3d's gather mode on the 6-channel grid;
    # p2g3d with 7 APIC channels beside them.
    spec_d = sim_d.spec
    args_d = fast3d.p2g_args(scene_d)
    mode_d = (args_d["apic"], args_d["ext"], args_d["tent"])
    check(mode_d == (True, False, False), f"drop3d: unexpected transfer mode {mode_d}")
    node_d = {n: args_d[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")}
    gd, dxd = args_d["g2"], args_d["dx"]
    fields_d = fast3d.prepped_fields(sim_d.state, scene_d, spec_d)
    counts_d = fast3d.pencil_counts(sim_d.state)
    mask_d = sim_d.state.mask.view(spec_d.rows0, spec_d.rows1, spec_d.capacity)
    err["p2g3d_apic7"], err["p2g3d_grid_drop3d"], err["g2p3d_drop3d"], grid6 = (
        compare_prepped3d("drop3d", fields_d, counts_d, mask_d, mode_d, node_d, gd, dxd, card))
    r0, r1, k3 = mask_d.shape
    live_d, n_in = int(counts_d.sum()), len(fields_d)
    nodes = (r0 + 4) * (r1 + 4) * gd
    dinv_d = float(4.0 * scene_d.cfg.inv_dx * scene_d.cfg.inv_dx)
    g2p_d = (*fields_d[:3], mask_d, counts_d, grid6, dxd, dinv_d)
    bounds.update({
        # live slots' 25 planes + counts in; the finished 6-channel padded
        # grid out; 27 taps x 7 channels of multiply-adds per live slot.
        "p2g3d_grid_drop3d": bound(4 * (n_in * live_d + r0 * r1 + tk3.G2P_CH * nodes),
                                   live_d * 27 * tk3.P2G_CH * 2),
        # live slots' [gx (3), mask] + counts + the 6-channel grid in; every
        # slot's 15 channels out; 27 taps x 15 sums per live slot.
        "g2p3d_drop3d": bound(
            4 * (4 * live_d + r0 * r1 + tk3.G2P_CH * nodes + 15 * r0 * r1 * k3),
            live_d * 27 * 15 * 2),
    })
    pairs = {
        "p2g3d_grid_drop3d": (
            lambda: tk3.p2g3d_grid(fields_d, counts_d, r1, **args_d),
            lambda: tk3.p2g3d_grid_plain(fields_d, counts_d, r1, **args_d)),
        "g2p3d_drop3d": (lambda: tk3.g2p3d(*g2p_d), lambda: tk3.g2p3d_plain(*g2p_d)),
    }
    for name, (call, plain_call) in pairs.items():
        kernel_ms[name] = cuda_ms(call, reps=10, warm=2)
        plain_ms[name] = cuda_ms(plain_call, reps=2, warm=1)
        say(f"[kernels:3dp] {name} ({n_in} planes, {grid6.shape[2]}-channel grid, buckets "
            f"{r0}x{r1}x{k3}, {live_d} live): kernel {kernel_ms[name]:.4f} ms (CUDA events, 10 "
            f"calls), plain {plain_ms[name]:.4f} ms (2 calls), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{card}]")
    plan_line("kernels:3dp", "drop3d", tk3.P2G_CH, gd, r0, r1, card, apic=True)
    del fields_d, counts_d, mask_d, grid6, g2p_d, pairs
    torch.cuda.empty_cache()

    # ---- 18b. timing:3dp, drop3d and the stabilized set at 1M ---------------------
    step_d = lambda s: fast3d.substep(s, scene_d, sim_d.spec)
    time_paths("3dp drop3d", fast3d, sim_d.state, scene_d, sim_d.spec, step_d, p_d.n, 27, 5, 3,
               card)
    del sim_d, p_d
    torch.cuda.empty_cache()
    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    scene1 = dataclasses.replace(scene1, cfg=dataclasses.replace(scene1.cfg, **STAB))
    spec1 = fast3d.FastSpec3D.for_particles(scene1.cfg, p1)
    b1 = fast3d.from_particles(p1, scene1.cfg, spec1, dev)
    step1 = lambda s: fast3d.substep(s, scene1, spec1)
    say(f"[timing:3dp stab3d 1M/128^3] {p1.n} particles, buckets {tuple(b1.shape)}")
    time_paths("3dp stab3d 1M/128^3", fast3d, b1, scene1, spec1, step1, p1.n, 27, 10, 3, card)
    say(f"[timing] 3D prepped phases done at {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# The slab-sharded path (--devices N): n slab shards on the one card
# ---------------------------------------------------------------------------


def local_rows(data, shards):
    """Row 0 (gx0) of (R, F, K) slot data made local to each of `shards`
    equal slabs of bucket rows, as the sharded path feeds the kernels."""
    r = data.shape[0]
    l = r // shards
    out = data.clone()
    out[:, 0] -= (torch.arange(r, device=data.device) // l * l).to(data.dtype)[:, None]
    return out


def compare_p2g_grid(tag, data, counts, kw, shards, g, dx, card):
    """`p2g_grid` raw (one call for all shards) against `p2g_grid_plain`
    and against fold_rows_halo of the single-device kernels (`p2g_fused` or
    `p2g`) per shard, every channel to 1e-5 of its max; the mass channel's
    sum against the live slots' mass (every tap of these inputs lies in
    the buffer).  Returns (worst absolute error, the raw sums)."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    got = tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw)
    want = tk.p2g_grid_plain(data, counts, g, dx, raw=True, shards=shards, **kw)
    err, rel = scaled_errors(got, want, axis=2)
    del want
    l = data.shape[0] // shards
    if kw["fused"]:
        single = lambda d, c: tk.p2g_fused(d, c, g, dx, **{
            n: kw[n] for n in ("apic", "eos", "kb", "mu", "gamma", "fa")})
    else:
        single = lambda d, c: tk.p2g(d, c, g, dx, tent=kw["tent"], apic=kw["apic"])
    via = torch.stack([tk.fold_rows_halo(single(data[s * l : (s + 1) * l],
                                                counts[s * l : (s + 1) * l]))
                       for s in range(shards)])
    _, rel_via = scaled_errors(got, via, axis=2)
    equal = torch.equal(got, via)
    diff = float((got - via).abs().max())
    FOLD["equal"] = FOLD["equal"] and equal
    FOLD["max_abs_diff"] = max(FOLD["max_abs_diff"], diff)
    del via
    live = torch.arange(data.shape[2], device=data.device)[None, :] < counts[:, None]
    m_total = (data[:, 9 if kw["fused"] else 12].double() * live).sum().item()
    pou = abs(got[:, :, 4].double().sum().item() - m_total) / m_total
    worst = int(np.argmax(rel))
    say(f"[kernels:sharded2d {tag}] p2g_grid raw, {shards} shards, {got.shape[2]} channels, "
        f"tent {kw.get('tent', False)}, G {g}: max_abs_err per channel "
        f"{['%.3e' % e for e in err]}; worst channel {worst}: {rel[worst]:.2e} of its max "
        f"(tol {KERNEL_REL_TOL}); against fold_rows_halo of the single-device kernel "
        f"{max(rel_via):.2e}, bitwise equal {equal} (max |diff| {diff:.3e}); mass sum rel err "
        f"{pou:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel) <= KERNEL_REL_TOL, f"{tag}: p2g_grid disagrees with its plain version")
    check(max(rel_via) <= KERNEL_REL_TOL, f"{tag}: p2g_grid disagrees with the fold of p2g")
    check(pou <= POU_REL_TOL, f"{tag}: p2g_grid partition of unity")
    return max(err), got


def p2g_grid_bytes(data, counts, shards, nch, g):
    """Live slots' rows + counts in, the raw (n, L + 4, nch, G) sums out."""
    r, f, _ = data.shape
    return 4 * (f * int(counts.sum()) + r + (r + 4 * shards) * nch * g)


def p2g_grid_bound(data, counts, shards, nch, g):
    """p2g_grid_bytes against 9 taps x nch channels of multiply-adds per
    live slot."""
    return bound(p2g_grid_bytes(data, counts, shards, nch, g),
                 int(counts.sum()) * 9 * nch * 2)


def ensemble(sim):
    """(mean, std) of the particle positions, float64."""
    x = sim.positions().astype(np.float64)
    return x.mean(axis=0), x.std(axis=0)


def state_errors(b, ref, dim):
    """Worst |b - ref| of the live slots' v and C, each over its group's
    largest |ref| entry, and of J (near 1: absolute); both layouts list a
    bucket row's (or pencil's) particles in the same order."""
    groups = {"v": [f"v{a}" for a in range(dim)],
              "C": [f"C{a}{c}" for a in range(dim) for c in range(dim)], "J": ["J"]}
    out = {}
    for group, names in groups.items():
        live = lambda s: torch.stack([getattr(s, n)[s.mask > 0] for n in names]).double()
        have, want = live(b), live(ref)
        err = float((have - want).abs().max())
        out[group] = err if group == "J" else err / float(want.abs().max())
        del have, want
    return out


def global_state(sim):
    """A Simulation's state in the global bucket order: the two-axis
    mesh's shard-major (s0, s1, l0, l1) reorder undone."""
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d

    if getattr(sim, "device_grid", None):
        return fast_domain3d.to_global(sim.state, sim.spec)
    return sim.state


def host_positions(b, dim):
    from mpm_flip98a_tpu_torch.models import fast2d, fast3d

    h = (fast3d if dim == 3 else fast2d).to_host(b)
    return np.stack([h[f"x{a}"] for a in range(dim)], -1)


def sharded_against_single(tag, p, scene, dev, shards, n_sub, card, vc_tol=KERNEL_REL_TOL):
    """`Simulation(devices=shards)` against `Simulation()` from the same
    particles: one substep slot for slot (the same particles in the same
    order: both bucket by the global row, the two-axis state read in the
    global order), x to 1e-6, v and C to
    KERNEL_REL_TOL of their largest entry and J to 1e-6 (x itself moves by
    less than its float32 ulp in one substep from rest, so v, C and J are
    what can see a wrong halo row or shard window); then n_sub - 1 more
    substeps compared by ensemble mean and std of x to 5e-4 (fp32 sums in
    another order at the slab edges amplify chaotically), zero overflow,
    constant mass.  `vc_tol` replaces v's and C's bound (the projection's
    cells: INCOMP_SHARD_TOL).  Returns the sharded Simulation and its
    launches."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    tmp = tempfile.gettempdir()
    mass0 = float(p.mass.to(torch.float32).double().sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tmp, device=dev, devices=shards)
    ref = driver.Simulation(p, scene, path="fast", out_dir=tmp, device=dev)
    tk.reset_launches()
    tk3.reset_launches()
    t0 = time.perf_counter()
    sim.run(1, 1, gif=False, verbose=False, write_frames=False)
    ref.run(1, 1, gif=False, verbose=False, write_frames=False)
    dim = scene.cfg.dim
    x1 = float(np.abs(host_positions(global_state(sim), dim) - ref.positions()).max())
    e1 = state_errors(global_state(sim), ref.state, dim)
    sim.run(1, n_sub - 1, gif=False, verbose=False, write_frames=False)
    ref.run(1, n_sub - 1, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = {**tk.LAUNCHES, **tk3.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    (m, s), (mr, sr) = ensemble(sim), ensemble(ref)
    d_mean, d_std = float(np.abs(m - mr).max()), float(np.abs(s - sr).max())
    say(f"[main:sharded {tag}] {p.n} particles, {shards} shards of "
        f"{sim.spec.rows_per_shard if scene.cfg.dim == 2 else sim.spec.rows_per_shard0} rows, "
        f"buckets {tuple(sim.state.shape)} against one device's {tuple(ref.state.shape)}; "
        f"{n_sub} substeps of both in {time.perf_counter() - t0:.2f} s; launches {got}; "
        f"after 1 substep: x max |diff| {x1:.3e} (tol 1e-6), v {e1['v']:.3e} and C "
        f"{e1['C']:.3e} of their max (tol {vc_tol}), J {e1['J']:.3e} (tol 1e-6); "
        f"after {n_sub}: ensemble mean "
        f"|diff| {d_mean:.3e}, std |diff| {d_std:.3e} (tol 5e-4); rebuckets "
        f"{sim.stats.rebuckets} against {ref.stats.rebuckets}; peak device memory {peak} bytes = "
        f"{peak / 2**30:.3f} GiB (both runs held)  [{card}]")
    check(x1 <= 1e-6, f"{tag}: sharded and single-device x differ after 1 substep")
    check(e1["v"] <= vc_tol and e1["C"] <= vc_tol and e1["J"] <= 1e-6,
          f"{tag}: sharded and single-device v, C or J differ after 1 substep: {e1}")
    check(d_mean <= 5e-4 and d_std <= 5e-4, f"{tag}: sharded run left the single-device ensemble")
    host_checks(f"sharded {tag}", sim, p.n, mass0, card)
    return sim, ref, got


def time_sharded(tag, sim, ref, n_sub, reps, card):
    """ms per substep of the sharded and the single-device run (each
    `run` of n_sub substeps ends in a synchronise), interleaved, median of
    `reps`; returns (sharded, single) medians."""
    runs = {"sharded": [], "single": []}
    for which, s in (("sharded", sim), ("single", ref)):    # warm-up
        s.step_frame(2)
    for _ in range(reps):
        for which, s in (("sharded", sim), ("single", ref)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.step_frame(n_sub)
            torch.cuda.synchronize()
            runs[which].append(1e3 * (time.perf_counter() - t0) / n_sub)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    say(f"[timing:sharded {tag}] {sim.devices} shards {med['sharded']:.4f} ms/substep "
        f"(median of {reps} x {n_sub}; runs {[round(t, 4) for t in runs['sharded']]}), one "
        f"device {med['single']:.4f} (runs {[round(t, 4) for t in runs['single']]}): sharding "
        f"costs {med['sharded'] - med['single']:+.4f} ms/substep on one card  [{card}]")
    return med["sharded"], med["single"]


def profile_sharded(profile_dir, sim, n_sub, wall_ms, tag, card):
    """torch.profiler over n_sub substeps of a sharded Simulation: the
    kernel table and the device's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    sim.step_frame(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.step_frame(n_sub)
        torch.cuda.synchronize()
    events = prof.key_averages()
    path = os.path.join(profile_dir, f"profile_sharded_{tag}_{n_sub}_substeps.txt")
    with open(path, "w") as f:
        f.write(f"{card}\n{events.table(sort_by='cuda_time_total', row_limit=40)}\n")
    busy_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in events
        if str(e.device_type).endswith("CUDA")
    ) / 1e3 / n_sub
    say(f"[timing:sharded {tag}] profile written to {path}: device busy {busy_ms:.4f} "
        f"ms/substep against {wall_ms:.4f} ms/substep unprofiled (idle share "
        f"{1.0 - busy_ms / wall_ms:.3f})  [{card}]")


def sharded2d_phases(dev, card, args, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 19-21 (2D): kernels:sharded2d, main:sharded2d and its
    timing:sharded rows."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
    from mpm_flip98a_tpu_torch.parallel import fast_domain

    shards = 4
    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC)
    cfg_stab = MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC)
    builds = {"bench": scenes.dam_break_2d(cfg, dtype=np.float32),
              "stab1M": scenes.dam_break_2d(cfg_stab, dtype=np.float32)}
    timing = {}

    # ---- 19. main:sharded2d: bench 1M and stab1M on 4 shards ----------------
    sims = {}
    for tag, (p, scene) in builds.items():
        sim, ref, got = sharded_against_single(tag, p, scene, dev, shards, 100, card)
        check(got["p2g_grid"] == 100 and got["g2p"] == 200,
              f"sharded {tag}: launches {got} for 100 substeps of the sharded and of the "
              "single-device run")
        check(got["p2g_fused" if fast2d.uses_fused(scene) else "p2g"] == 100,
              f"sharded {tag}: the single-device run's P2G count")
        check(got["p2g3d_grid"] == got["g2p3d"] == 0, f"sharded {tag}: a 3D kernel ran")
        sims[tag] = (sim, ref)
    # The sharded run alone, counted: one p2g_grid and one g2p per substep.
    sim = sims["bench"][0]
    tk.reset_launches()
    tk3.reset_launches()
    sim.step_frame(100)
    torch.cuda.synchronize()
    launches["p2g_grid"] = tk.LAUNCHES["p2g_grid"]
    launches["g2p prepadded"] = tk.LAUNCHES["g2p"]
    check(launches["p2g_grid"] == launches["g2p prepadded"] == 100 and
          tk.LAUNCHES["p2g_fused"] == tk.LAUNCHES["p2g"] == 0,
          f"sharded bench: launches {tk.LAUNCHES} for 100 substeps")
    sim = sims["stab1M"][0]
    tk.reset_launches()
    sim.step_frame(20)
    torch.cuda.synchronize()
    launches["p2g_grid prepped"] = tk.LAUNCHES["p2g_grid"]
    check(tk.LAUNCHES["p2g_grid"] == tk.LAUNCHES["g2p"] == 20 and tk.LAUNCHES["p2g"] == 0,
          f"sharded stab1M: launches {tk.LAUNCHES} for 20 substeps")
    say(f"[main:sharded] launches of the sharded runs alone: bench 100 substeps -> "
        f"p2g_grid {launches['p2g_grid']}, g2p {launches['g2p prepadded']}; stab1M 20 "
        f"substeps -> p2g_grid {launches['p2g_grid prepped']}")

    # ---- 20. kernels:sharded2d ------------------------------------------------
    dx = float(cfg.dx)
    g = cfg.num_grids
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    for tag, key in (("bench", "p2g_grid"), ("stab1M", "p2g_grid_prepped")):
        sim = sims[tag][0]
        scene = sim.scene
        ctx = fast_domain.FastDomainCtx(sim.mesh, sim.spec.rows_per_shard)
        data, pdata2, counts = fast2d.transfer_inputs(sim.state, scene, ctx)
        kw = {n: v for n, v in fast2d.p2g_args(scene).items() if n not in ("g", "dx")}
        kw["fused"] = fast2d.uses_fused(scene)
        err[key], raw = compare_p2g_grid(tag, data, counts, kw, shards, g, dx, card)
        grid = fast2d._grid_update2d(ctx.halo_sync(raw), scene, ctx.row_index0(dev))
        gkey = "g2p_prepadded" if tag == "bench" else "g2p_prepadded_ext"
        err[gkey] = compare_g2p(f"kernels:sharded2d {tag}", pdata2, counts, grid, dx, dinv,
                                False, card, prepadded=True)
        kernel_ms[key] = cuda_ms(lambda: tk.p2g_grid(data, counts, g, dx, raw=True,
                                                     shards=shards, **kw))
        rerun_equal(f"kernels:sharded2d {tag}", "p2g_grid", lambda: tk.p2g_grid(
            data, counts, g, dx, raw=True, shards=shards, **kw), card)
        ACHIEVED[key] = achieved(f"p2g_grid at {tag} in {shards} shards",
                                 p2g_grid_bytes(data, counts, shards, raw.shape[2], g),
                                 kernel_ms[key], card)
        plain_ms[key] = cuda_ms(lambda: tk.p2g_grid_plain(data, counts, g, dx, raw=True,
                                                          shards=shards, **kw), reps=3, warm=1)
        bounds[key] = p2g_grid_bound(data, counts, shards, raw.shape[2], g)
        kernel_ms[gkey] = cuda_ms(lambda: tk.g2p(pdata2, counts, grid, dx, dinv,
                                                 prepadded=True))
        plain_ms[gkey] = cuda_ms(lambda: tk.g2p_plain(pdata2, counts, grid, dx, dinv,
                                                      prepadded=True), reps=3, warm=1)
        r2, k2 = pdata2.shape[0], pdata2.shape[2]
        live2, gch = int(counts.sum()), grid.shape[2]
        bounds[gkey] = bound(4 * (3 * live2 + r2 + grid.numel() + (4 + gch) * r2 * k2),
                             live2 * 9 * (4 + gch) * 2)
        halo = raw.clone()
        timing[f"halo {tag}"] = cuda_ms(lambda: ctx.halo_sync(halo))
        say(f"[kernels:sharded2d {tag}] at {shards} shards (buckets {r2}x{k2}, {live2} live): "
            f"p2g_grid {kernel_ms[key]:.4f} ms (CUDA events, 20 calls: gather + fold), plain "
            f"{plain_ms[key]:.4f} ms (3 calls), bound {bounds[key][0]:.4f} ms "
            f"({bounds[key][1]}); g2p prepadded ({gch} channels) {kernel_ms[gkey]:.4f} ms, plain "
            f"{plain_ms[gkey]:.4f}, bound {bounds[gkey][0]:.4f} ({bounds[gkey][1]}); halo_sync "
            f"on ({', '.join(map(str, raw.shape))}) {timing[f'halo {tag}']:.4f} ms  [{card}]")
        del data, pdata2, counts, raw, grid, halo
    # The ragged tent case at G = 2049 (column bands) in 4 shards of 12 rows.
    rp, rp2, rc, _, rg = ragged_prepped(dev)
    rkw = dict(fused=False, tent=True, apic=False)
    rdx = 0.4375 / (rg - 5)
    rp = local_rows(rp, shards)
    err["p2g_grid_tent"], _ = compare_p2g_grid("ragged tent", rp, rc, rkw, shards, rg, rdx,
                                                card)
    kernel_ms["p2g_grid_tent"] = cuda_ms(lambda: tk.p2g_grid(rp, rc, rg, rdx, raw=True,
                                                             shards=shards, **rkw))
    bounds["p2g_grid_tent"] = p2g_grid_bound(rp, rc, shards, 9, rg)
    rerun_equal("kernels:sharded2d ragged tent", "p2g_grid", lambda: tk.p2g_grid(
        rp, rc, rg, rdx, raw=True, shards=shards, **rkw), card)
    ACHIEVED["p2g_grid_tent"] = achieved("p2g_grid on the ragged tent case",
                                         p2g_grid_bytes(rp, rc, shards, 9, rg),
                                         kernel_ms["p2g_grid_tent"], card)
    say(f"[kernels:sharded2d ragged tent] p2g_grid {kernel_ms['p2g_grid_tent']:.4f} ms at "
        f"{tuple(rp.shape)}, G {rg}, bound {bounds['p2g_grid_tent'][0]:.4f} ms  [{card}]")
    del rp, rp2, rc

    # ---- 21. timing:sharded (2D) ---------------------------------------------
    for tag, (sim, ref) in sims.items():
        timing[tag] = time_sharded(tag, sim, ref, 100, 3, card)
        say(f"[timing:sharded {tag}] halo_sync {timing[f'halo {tag}']:.4f} ms of the "
            f"{timing[tag][0]:.4f} ms substep  [{card}]")
        if args.profile:
            profile_sharded(args.profile, sim, 20, timing[tag][0], tag, card)
    del sims, sim, ref
    torch.cuda.empty_cache()

    # ---- 22. main:sharded2d: migration at 37^2 and the CLI --------------------
    mig = dict(MIGRATE)
    n_t, n_mig = mig.pop("shards"), mig.pop("substeps")
    cfg_t = MPMConfig(dtype="float32", flip_blend=0.98, transfer=TransferKind.PIC, **mig)
    p_t, scene_t = scenes.dam_break_2d(cfg_t, dtype=np.float32)
    sim = driver.Simulation(p_t, scene_t, path="fast", out_dir=tempfile.gettempdir(), device=dev,
                            devices=n_t)
    ref = driver.Simulation(p_t, scene_t, path="fast", out_dir=tempfile.gettempdir(), device=dev)
    live0 = (sim.state.mask.view(n_t, -1) > 0).sum(dim=1).tolist()
    t0 = time.perf_counter()
    sim.run(1, n_mig, gif=False, verbose=False, write_frames=False)
    ref.run(1, n_mig, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    live1 = (sim.state.mask.view(n_t, -1) > 0).sum(dim=1).tolist()
    (m, s), (mr, sr) = ensemble(sim), ensemble(ref)
    d_mean, d_std = float(np.abs(m - mr).max()), float(np.abs(s - sr).max())
    say(f"[main:sharded migrate37] {p_t.n} particles, {cfg_t.num_grids}^2, dt {cfg_t.dt}, "
        f"{n_t} shards of {sim.spec.rows_per_shard} rows, {n_mig} substeps of both in "
        f"{time.perf_counter() - t0:.2f} s; live slots per shard {live0} -> {live1}; "
        f"rebuckets {sim.stats.rebuckets}; ensemble mean |diff| {d_mean:.3e}, std |diff| "
        f"{d_std:.3e} (tol 5e-4)  [{card}]")
    check(live0 != live1, f"migrate37: no slot changed shards in {n_mig} substeps")
    check(d_mean <= 5e-4 and d_std <= 5e-4, "migrate37: left the single-device ensemble")
    host_checks("sharded migrate37", sim, p_t.n, float(p_t.mass.to(torch.float32).double().sum()),
                card)
    del sim, ref

    run_cli(dev, card, "dam2d_flip98", "4", 2, 100, ("p2g_grid", "g2p"), launches)
    return timing


def run_cli(dev, card, scenario, devices, n_frames, n_sub, ran, launches):
    """The port's CLI with --devices (Simulation where no frame writer
    exists); each kernel of `ran` launched once per substep."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        argv = ["--scenario", scenario, "--path", "fast", "--devices", devices, "--frames",
                str(n_frames), "--substeps", str(n_sub), "--no-gif", "--out", out_dir,
                "--device", "cuda"]
        p_ref, scene = driver.SCENARIOS[scenario]()
        mass = float(p_ref.mass.to(torch.float32).double().sum())
        tk.reset_launches()
        tk3.reset_launches()
        t0 = time.perf_counter()
        if frame_io_available():
            sim = driver.main(argv)
        else:
            sim = driver.Simulation(p_ref, scene, path="fast", out_dir=out_dir, device=dev,
                                    devices=int(devices))
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        got = {**tk.LAUNCHES, **tk3.LAUNCHES}
        say(f"[main:sharded {scenario}] CLI {' '.join(argv)} in {time.perf_counter() - t0:.2f} s: "
            f"launches {got}, substeps {sim.stats.substeps}, shards {sim.devices}")
        check(sim.devices == int(devices), f"{scenario}: {sim.devices} shards")
        for name in ran:
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{scenario} --devices {devices}: {name} launched {got[name]} times")
            launches[f"{name} cli {scenario}"] = got[name]
        host_checks(f"sharded {scenario}", sim, p_ref.n, mass, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def compare_g2p3d_sharded(tag, planes, mask, counts, state, scene, gspec, ctx, err, kernel_ms,
                          plain_ms, bounds, card, key=None):
    """`g2p3d` on the shard windows (n, L0 + 4, R1 + 4, gch, G2) of the
    halo-synced, grid-updated raw sums, as the sharded substep feeds it,
    against `g2p3d_plain` on the same inputs: the update mode with the
    fused state (`state` given), else the gather mode.  Each output
    channel to KERNEL_REL_TOL of its max (C: of one term's size, J and
    Jbar: of 1); then its time, plain time and bound, under `key` if given."""
    from mpm_flip98a_tpu_torch.config import KernelKind
    from mpm_flip98a_tpu_torch.models import fast3d
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    cfg = scene.cfg
    tent = cfg.kernel == KernelKind.TENT        # gather mode only: C = B D^-1 after it
    dx, dinv = float(cfg.dx), 1.0 if tent else float(4.0 * cfg.inv_dx * cfg.inv_dx)
    grid = fast3d._sharded_grid(planes, counts, scene, gspec, False, ctx)
    g2p_in = (*planes[:3], mask, counts, grid, dx, dinv)
    if state is not None:
        name, g2p_kw = "g2p3d_sharded", {}
        g2p_in += (state, float(cfg.flip_blend), float(cfg.dt))
    else:
        name, g2p_kw = "g2p3d_sharded_gather", dict(tent=tent)
    name = key or name
    got = tk3.g2p3d(*g2p_in, **g2p_kw)
    want = tk3.g2p3d_plain(*g2p_in, **g2p_kw)
    scale = want.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = dinv * dx * float(grid[:, :, :, :3].abs().max())    # C: one term's size
    if scale.numel() > 15:
        scale[15] = max(float(scale[15]), 1.0)                          # J or Jbar near 1
    err_u, rel_u = scaled_errors(got, want, axis=2, scale=scale)
    worst = int(np.argmax(rel_u))
    err[name] = max(err_u)
    say(f"[kernels:sharded3d {tag}] g2p3d on {grid.shape[0]} shard windows "
        f"{tuple(grid.shape[1:])}, {got.shape[2]} outputs: max_abs_err per channel "
        f"{['%.2e' % e for e in err_u]}; worst channel {worst}: {rel_u[worst]:.2e} of its scale "
        f"(tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel_u) <= KERNEL_REL_TOL, f"{tag}: g2p3d on the shard windows disagrees with plain")
    nout = got.shape[2]
    del got, want
    kernel_ms[name] = cuda_ms(lambda: tk3.g2p3d(*g2p_in, **g2p_kw), reps=10)
    plain_ms[name] = cuda_ms(lambda: tk3.g2p3d_plain(*g2p_in, **g2p_kw), reps=2, warm=1)
    slots, live = mask.numel(), int(counts.sum())
    if state is not None:
        # live slots' 11 planes, dead slots' x (3), counts and the grid in;
        # every slot's 16 channels out; 27 taps x 15 sums per live slot.
        bounds[name] = bound(4 * (11 * live + 3 * (slots - live) + counts.numel() + grid.numel()
                                  + nout * slots), live * 27 * (nout - 1) * 2)
    else:
        # live slots' gx (3) + mask, counts and the grid in; every slot's
        # outputs out; 27 taps x nout sums per live slot.
        bounds[name] = bound(4 * (4 * live + counts.numel() + grid.numel() + nout * slots),
                             live * 27 * nout * 2)
    say(f"[kernels:sharded3d {tag}] g2p3d on the shard windows {kernel_ms[name]:.4f} ms (CUDA "
        f"events, 10 calls, one launch each), plain {plain_ms[name]:.4f} ms (2 calls), bound "
        f"{bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")


def sharded3d_phases(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds, launches,
                     timing):
    """Phases 23-25 (3D, one axis): main:sharded3d, kernels:sharded3d and
    the timing:sharded rows of slab 8M and stab3d-8M on 4 shards."""
    from mpm_flip98a_tpu_torch.models import scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    shards = 4
    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    scene_stab = dataclasses.replace(scene8, cfg=dataclasses.replace(scene8.cfg, **STAB))
    for tag, scene, key, n_sub in (("slab8M", scene8, "raw", 50),
                                   ("stab3d-8M", scene_stab, "raw_prepped", 20)):
        sim, ref, got = sharded_against_single(tag, p8, scene, dev, shards, n_sub, card)
        check(got["p2g3d_grid"] == got["g2p3d"] == 2 * n_sub and got["p2g3d"] == 0,
              f"sharded {tag}: launches {got}")
        check(got["p2g_grid"] == got["p2g_fused"] == got["p2g"] == got["g2p"] == 0,
              f"sharded {tag}: a 2D kernel ran")
        tk.reset_launches()
        tk3.reset_launches()
        sim.step_frame(5)
        torch.cuda.synchronize()
        launches[f"p2g3d_grid {key}"] = tk3.LAUNCHES["p2g3d_grid"]
        launches[f"g2p3d {key}"] = tk3.LAUNCHES["g2p3d"]
        check(tk3.LAUNCHES["p2g3d_grid"] == tk3.LAUNCHES["g2p3d"] == 5,
              f"sharded {tag}: {tk3.LAUNCHES} for 5 substeps")

        # ---- kernels:sharded3d: the raw mode against plain on this state
        timing[f"halo {tag}"] = windows_against_plain(
            tag, sim, scene, f"p2g3d_grid_{key}", None, err, kernel_ms, plain_ms, bounds, card,
            plan_key=key)
        timing[tag] = time_sharded(tag, sim, ref, 10, 3, card)
        say(f"[timing:sharded {tag}] halo_sync {timing[f'halo {tag}']:.4f} ms of the "
            f"{timing[tag][0]:.4f} ms substep  [{card}]")
        if profile_dir:
            profile_sharded(profile_dir, sim, 3, timing[tag][0], tag, card)
        del sim, ref
        torch.cuda.empty_cache()
    del p8
    run_cli(dev, card, "dam3d", "2", 2, 100, ("p2g3d_grid", "g2p3d"), launches)


# ---------------------------------------------------------------------------
# Rigid SDF colliders
# ---------------------------------------------------------------------------


def penetration(sim):
    """The deepest particle inside any of the scene's colliders at their
    final position (signed distance at the particles, float64), in dx;
    -inf without colliders."""
    from mpm_flip98a_tpu_torch.models import colliders

    x = sim.positions().astype(np.float64)
    coords = [torch.from_numpy(np.ascontiguousarray(x[:, a])) for a in range(x.shape[1])]
    phi = min((float(colliders.phi_normal(c, coords, sim.total_time)[0].min())
               for c in sim.scene.colliders), default=np.inf)
    return -phi / sim.cfg.dx


def run_collider_cli(dev, card, io_ok, scenario, n_frames, n_sub, ran, idle, launches):
    """A collider scenario through the CLI (Simulation where no frame
    writer exists): launches, the host checks, and no particle deeper than
    1.5 dx inside a collider (tests/test_colliders.py:176-196, 507-512)."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        argv = ["--scenario", scenario, "--path", "fast", "--frames", str(n_frames),
                "--substeps", str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda"]
        p_ref, scene = driver.SCENARIOS[scenario]()
        mass = float(p_ref.mass.to(torch.float32).double().sum())
        tk.reset_launches()
        tk3.reset_launches()
        t0 = time.perf_counter()
        if io_ok:
            sim = driver.main(argv)
        else:
            sim = driver.Simulation(p_ref, scene, path="fast", out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        got = {**tk.LAUNCHES, **tk3.LAUNCHES}
        depth = penetration(sim)
        say(f"[main:colliders {scenario}] {'CLI ' + ' '.join(argv) if io_ok else 'Simulation'} "
            f"in {time.perf_counter() - t0:.2f} s: launches {got}, substeps "
            f"{sim.stats.substeps}, colliders {sim.scene.colliders}, deepest particle inside "
            f"a collider {depth:.3f} dx (bound 1.5)  [{card}]")
        for name in ran:
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{scenario}: {name} launched {got[name]} times")
            launches[f"{name} cli {scenario}"] = got[name]
        for name in idle:
            check(got[name] == 0, f"{scenario}: {name} ran")
        check(depth < 1.5, f"{scenario}: a particle {depth:.3f} dx inside a collider")
        host_checks(f"colliders {scenario}", sim, p_ref.n, mass, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def collider_set3d(g, dx):
    """The ragged case's colliders: a slip sphere, a sticky box with a
    surface velocity and a moving center, a halfspace spinner about its
    normal (node x = (idx - 2) dx)."""
    from mpm_flip98a_tpu_torch.models.colliders import Collider

    l = (g - 5) * dx
    n = np.array([0.15, -0.1, 1.0])
    return (
        Collider(kind="sphere", center=(0.45 * l, 0.5 * l, 0.35 * l), radius=0.2 * l),
        Collider(kind="box", center=(0.7 * l, 0.3 * l, 0.6 * l),
                 half_extents=(0.12 * l, 0.2 * l, 0.1 * l), sticky=True,
                 velocity=(0.3, 0.0, -0.2), center_velocity=(0.5, 0.0, 0.0)),
        Collider(kind="halfspace", center=(0.0, 0.0, 0.15 * l), normal=tuple(n),
                 angular=tuple(5.0 * n / np.linalg.norm(n))),
    )


def inside_flips(call, colliders, r0, r1):
    """Nodes whose inside flag differs between the kernel and the plain
    version.  Each collider made sticky with a sentinel surface velocity
    (1000 (i + 1) m/s, no spin) pins the nodes inside it to exactly that
    value in both; `call(colliders, kernel)` returns the finished grid.
    Returns (flips, nodes inside) over the interior rows."""
    probes = tuple(dataclasses.replace(c, sticky=True, angular=(), velocity=(1e3 * (i + 1),) * 3)
                   for i, c in enumerate(colliders))
    marks = torch.tensor([float(np.float32(1e3 * (i + 1))
                                + np.float32((c.center_velocity or (0.0,))[0]))
                          for i, c in enumerate(probes)])
    flags = [torch.isin(call(probes, kernel)[1 : r0 + 1, 1 : r1 + 1, 0].cpu(), marks)
             for kernel in (True, False)]
    return int((flags[0] != flags[1]).sum()), int(flags[1].sum())


def compare_colliders3d(tag, fields, counts, kw, colliders, tcol, card):
    """`p2g3d_grid`'s collider mode against `p2g3d_grid_plain` on one set
    of inputs: the finished grid weighted by the nodal mass (volume for the
    ext averages) per channel as a fraction of that weighted channel's max,
    the nodes no mass reached (where the colliders write the surface
    velocity) unweighted as a fraction of the channel max, the axis-0 pad
    rows, and the nodes whose inside flag differs.  Returns (worst abs err,
    flips)."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    r0, r1, _ = fields[0].shape
    g2, dx = kw["g2"], kw["dx"]
    args = {n: v for n, v in kw.items() if n not in ("g2", "dx")}

    def call(cols, kernel):
        fn = tk3.p2g3d_grid if kernel else tk3.p2g3d_grid_plain
        return fn(fields, counts, r1, g2, dx, **args, colliders=cols, tcol=tcol)

    got, want, free = call(colliders, True), call(colliders, False), call((), False)
    scatter = {n: args[n] for n in ("apic", "stress", "kb", "mu", "gamma", "fa", "tent", "ext")
               if n in args}
    raw = tk3.p2g3d_raw_plain(fields, counts, g2, dx, **scatter)
    ext = got.shape[2] == tk3.G2P_CH_EXT
    diff = (got - want).double().abs()
    weight = [raw[:, :, 6:7].double()] * 6 + [raw[:, :, 8:9].double()] * (3 * ext)
    # Scaled by the weighted finished channel's max, not the raw sum's: a
    # collider gives nodes velocities the sums never had (the rising
    # sphere's 2 m/s in a slab at rest), and the slip projection turns the
    # roundoff of the pressure-balanced v_z into v_x and v_y.
    tops = [max(float((want[:, :, ch : ch + 1].double().abs() * weight[ch]).max()), 1e-30)
            for ch in range(got.shape[2])]
    rel_w = [float((diff[:, :, ch : ch + 1] * weight[ch]).max()) / tops[ch]
             for ch in range(got.shape[2])]
    empty = raw[:, :, 6] == 0
    rel_e = [float(diff[:, :, a][empty].max() / want[:, :, a].double().abs().max().clamp(min=1e-30))
             for a in range(3)] if bool(empty.any()) else [0.0]
    acted = float((want[:, :, :3] - free[:, :, :3]).abs().max())
    pads_zero = not bool(got[0].any()) and not bool(got[r0 + 1:].any())
    flips, inside = inside_flips(call, colliders, r0, r1)
    say(f"[kernels:colliders {tag}] p2g3d_grid, {len(colliders)} colliders, tcol {tcol}: "
        f"finished grid mass-weighted scaled {['%.2e' % r for r in rel_w]}, empty nodes "
        f"scaled {['%.2e' % r for r in rel_e]} (tol {KERNEL_REL_TOL}); max |v| change by "
        f"the colliders {acted:.3e}; axis-0 pads zero {pads_zero}; inside-flag flips {flips} "
        f"of {inside} inside nodes  [{card}]")
    check(max(rel_w + rel_e) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid colliders disagree with plain")
    check(acted > 0.0 and inside > 0, f"{tag}: the colliders never acted")
    check(pads_zero, f"{tag}: p2g3d_grid axis-0 pad rows not zero")
    check(flips == 0, f"{tag}: {flips} nodes flip inside/outside between kernel and plain")
    rerun_equal(f"kernels:colliders {tag}", "p2g3d_grid_colliders",
                lambda: call(colliders, True), card)
    return float(diff.max()), flips


def collider_phases(dev, card, io_ok, profile_dir, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 26-29: main:colliders (the collider scenarios' CLIs),
    main:obstacle8M (the 8M slab cut by a static and by a rising sphere),
    kernels:colliders and timing:colliders.  Returns the count of nodes
    whose inside flag differs between kernel and plain, over every case."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import colliders, fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    # ---- 26. main:colliders ------------------------------------------------
    for scenario, n_sub, ran, idle in (
        ("dam2d_obstacle", 200, ("p2g_fused", "g2p"), ("p2g3d_grid", "g2p3d")),
        ("plow2d", 200, ("p2g_fused", "g2p"), ("p2g3d_grid", "g2p3d")),
        ("dam3d_obstacle", 100, ("p2g3d_grid", "g2p3d"), ("p2g_fused", "g2p", "p2g3d")),
    ):
        run_collider_cli(dev, card, io_ok, scenario, 2, n_sub, ran, idle, launches)

    # ---- 27. main:obstacle8M ------------------------------------------------
    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    l = scene8.cfg.domain_length
    mass8 = float(p8.mass.to(torch.float32).double().sum())
    cases = {
        # dam_break_obstacle_3d's sphere (scenes.py): it cuts the 0.125 l slab.
        "static": ((colliders.Collider(kind="sphere", center=(0.55 * l, 0.50 * l, 0.12 * l),
                                       radius=0.10 * l),), None),
        # tests/test_colliders.py:594-601's rising sphere, from t0 = 0.01 s.
        "rising": ((colliders.Collider(kind="sphere", center=(0.5 * l, 0.5 * l, -0.10 * l),
                                       radius=0.12 * l, center_velocity=(0.0, 0.0, 2.0)),), 0.01),
    }
    n_frames, n_sub = 2, 10
    g = scene8.cfg.num_grids
    idx = torch.arange(g, device=dev)
    coords = colliders.node_coords(scene8.cfg, [idx[:, None, None], idx[:, None], idx])
    states = {}
    for tag, (cols, t0) in cases.items():
        scene = dataclasses.replace(scene8, colliders=cols)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = driver.Simulation(p8, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev)
        if t0 is not None:
            sim.total_time = t0          # the run's t0: the frame loop's clock
        ts = (None,) if t0 is None else (t0, t0 + (n_frames * n_sub - 1) * scene.cfg.dt)
        inside = [int(colliders.inside_any(coords, cols, t).sum()) for t in ts]
        tk.reset_launches()
        tk3.reset_launches()
        t_0 = time.perf_counter()
        sim.run(n_frames, n_sub, gif=False, verbose=False, write_frames=False)
        torch.cuda.synchronize()
        got = {**tk.LAUNCHES, **tk3.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        say(f"[main:obstacle8M {tag}] {p8.n} particles, grid {g}^3, buckets "
            f"{tuple(sim.state.shape)}, colliders {cols}, t0 {t0}: grid nodes inside the "
            f"collider {inside} (at the first and the last substep); Simulation {n_frames} "
            f"frames x {n_sub} substeps in {time.perf_counter() - t_0:.2f} s, launches {got}; "
            f"peak device memory {peak} bytes = {peak / 2**30:.3f} GiB "
            f"({PEAK_BEFORE_GIB[f'obstacle8M {tag}']} GiB with the atomic-scatter p2g3d_grid)  "
            f"[{card}]")
        for name in ("p2g3d_grid", "g2p3d"):
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"obstacle8M {tag}: {name} launched {got[name]} times")
            launches[f"{name} obstacle8M {tag}"] = got[name]
        check(got["p2g3d"] == got["p2g_fused"] == got["g2p"] == 0, f"obstacle8M {tag}: launches")
        check(min(inside) > 0, f"obstacle8M {tag}: no grid node inside the collider")
        host_checks(f"obstacle8M {tag}", sim, p8.n, mass8, card)
        states[tag] = (sim.state, scene, sim.spec, t0)
        del sim
    launches["p2g3d_grid colliders"] = launches["p2g3d_grid obstacle8M static"]

    # ---- 28. kernels:colliders ---------------------------------------------
    b, scene, spec, _ = states["static"]
    planes, counts, _, _ = fast3d.transfer_inputs(b, spec, scene.cfg)
    kw = fast3d.p2g_args(scene)
    flips = []
    for tag, (_, sc, _, t0) in states.items():
        kw_t = {**fast3d.p2g_args(sc)}
        cols = kw_t.pop("colliders")
        e, f = compare_colliders3d(f"obstacle8M {tag}", planes, counts, kw_t, cols, t0, card)
        err[f"p2g3d_grid_colliders_{tag}"] = e
        flips.append(f)
    r0, r1, k3 = planes[0].shape
    call = lambda cols: tk3.p2g3d_grid(planes, counts, r1, **{**kw, "colliders": cols})
    kernel_ms["p2g3d_grid_colliders"] = cuda_ms(lambda: call(kw["colliders"]))
    kernel_ms["p2g3d_grid_colliders_free"] = cuda_ms(lambda: call(()))
    plain_ms["p2g3d_grid_colliders"] = cuda_ms(
        lambda: tk3.p2g3d_grid_plain(planes, counts, r1, **kw), reps=3, warm=1)
    live3 = int(counts.sum())
    nodes = (r0 + 4) * (r1 + 4) * kw["g2"]
    # The stress mode's bytes (colliders add none): live slots' 18 planes +
    # counts in, the finished 6-channel grid out; 27 x 7 multiply-adds per
    # live slot and some 30 flops per node for the projection.
    bounds["p2g3d_grid_colliders"] = bound(
        4 * (18 * live3 + r0 * r1 + 6 * nodes), live3 * 27 * 7 * 2 + 30 * nodes)
    say(f"[kernels:colliders] p2g3d_grid at the obstacle8M shapes (buckets {r0}x{r1}x{k3}, "
        f"{live3} live): collider mode {kernel_ms['p2g3d_grid_colliders']:.4f} ms, the same "
        f"call with colliders=() {kernel_ms['p2g3d_grid_colliders_free']:.4f} ms (CUDA events, "
        f"20 calls), plain {plain_ms['p2g3d_grid_colliders']:.4f} ms (3 calls), bound "
        f"{bounds['p2g3d_grid_colliders'][0]:.4f} ms ({bounds['p2g3d_grid_colliders'][1]})  "
        f"[{card}]")
    plan_line("kernels:colliders", "colliders", tk3.P2G_CH, kw["g2"], r0, r1, card,
              apic=bool(kw["apic"]))
    del planes, counts
    torch.cuda.empty_cache()
    rplanes, _, rcounts, _, rg, rdx = ragged_inputs3d(dev, seed=5, r=32, k=128, g=32)
    node = {n: kw[n] for n in ("dt", "grav", "floor", "lo", "wall", "beta")}
    node["hi"] = rg - 3
    cols = collider_set3d(rg, rdx)
    stress = {"apic": False, "stress": "tait", "kb": kw["kb"], "mu": kw["mu"],
              "gamma": kw["gamma"], "fa": -kw["dt"] * 4.0 / rdx**2}
    e, f = compare_colliders3d("ragged stress", rplanes, rcounts,
                               {**stress, **node, "g2": rg, "dx": rdx}, cols, 0.05, card)
    errs = [e]
    flips.append(f)
    for tag, tent in (("ragged prepped11", False), ("ragged tent", True)):
        fields, _, fcounts, _, _ = ragged_prepped3d(dev, False, True, seed=6, r=32, k=128, g=32)
        e, f = compare_colliders3d(tag, fields, fcounts, {
            "apic": False, "ext": True, "tent": tent, **node, "g2": rg, "dx": rdx}, cols, 0.05,
            card)
        errs.append(e)
        flips.append(f)
    err["p2g3d_grid_colliders"] = max(errs + [err[f"p2g3d_grid_colliders_{t}"] for t in states])
    del rplanes, rcounts

    # ---- 29. timing:colliders -----------------------------------------------
    scene_free = dataclasses.replace(scene, colliders=())
    runs = {"slab 8M": [], "obstacle8M": []}
    for sc in (scene_free, scene):
        time_run(fast3d, b, sc, spec, 3, False)
    n_time = 10
    for _ in range(3):    # interleaved: slab, obstacle, slab, obstacle ...
        for name, sc in (("slab 8M", scene_free), ("obstacle8M", scene)):
            runs[name].append(1e3 * time_run(fast3d, b, sc, spec, n_time, False) / n_time)
    med = {name: float(np.median(ts)) for name, ts in runs.items()}
    say(f"[timing:colliders] from the same 8M particles: obstacle8M {med['obstacle8M']:.4f} "
        f"ms/substep, slab 8M {med['slab 8M']:.4f} ms/substep (median of 3 x {n_time}; runs "
        f"{ {k: [round(t, 4) for t in v] for k, v in runs.items()} }), ratio "
        f"{med['obstacle8M'] / med['slab 8M']:.4f}  [{card}]")
    if profile_dir:
        profile_window(os.path.join(profile_dir, "profile_obstacle8M_5_substeps.txt"), fast3d,
                       b, scene, spec, 5, med["obstacle8M"], "colliders obstacle8M", card)
    del states, b
    torch.cuda.empty_cache()
    return sum(flips)


# ---------------------------------------------------------------------------
# The general path (models/stabilized.py) and the MLS-MPM validation model
# ---------------------------------------------------------------------------

# The reference workload's golden statistics: deterministic float64 CPU
# values of the JAX general path (tests/test_golden_reference.py:27-36;
# 105^2, dt 1e-6, 8,450 particles, APIC + B-spline), and their bound.
GOLDEN_REFERENCE = {
    10000: dict(com_x=0.02861624, com_y=0.05665837, std_x=0.01651807, front=0.05723588),
    20000: dict(com_x=0.02898977, com_y=0.05567413, std_x=0.01672892, front=0.05909730),
    30000: dict(com_x=0.02964613, com_y=0.05408680, std_x=0.01711508, front=0.06209041),
}
GOLDEN_TOL = 1e-5
# One general substep on the card against the CPU (and against a second
# card run), per field as a share of its scale.  The card's index_add_
# adds with atomics in no fixed order.  float64: every field 1e-12.
# float32: the state a substep carries on; v and C are sums over nodes
# whose force terms cancel (read on an H100: 2.4e-6 and 1.1e-5 card vs
# CPU, 2.0e-6 and 8.8e-6 between two card runs, stab1M set at 37^2), so
# they are held at 1e-4, the rest at 1e-6.  Pressure, stress and div_v
# (K (J - 1): one float32 ulp of J is 0.12 Pa) are printed only.
GENERAL_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
CARRIED = {"x": 1e-6, "v": 1e-4, "C": 1e-4, "F": 1e-6, "J": 1e-6, "density": 1e-6,
           "Jp": 1e-6}
# general against fast after one substep (tests/test_fast2d.py:56-57).
VS_FAST_TOL = {"x": 1e-7, "v": 1e-4}
# The stab1M switch set cut to 37^2: the bench column and dt, 128 x 64
# particles (four a cell per axis, as at 513^2).
STAB37 = dict(BENCH, **STAB, num_grids=37, num_particles_x=128, num_particles_y=64)
# The validation model (tests/test_mls_mpm_vs_oracle.py:42-55): one
# substep from each warm-up, card against CPU, within 1e-5.  That file's
# warm-ups 50 and 200 run in float64 (the oracle's step promotes the
# state), where C reaches 522 (a float32 ulp there is 6.1e-5): float32 is
# held to 1e-5 of each field's scale, float64 to 1e-5 absolute.  300
# float64 substeps within the trajectory bound of that file (:73-76).
MLS_WARMUPS = (0, 50, 200)
MLS_TOL = 1e-5
MLS_TRAJ_TOL = 5e-4
GENERAL = {}                 # the {"general": ...} line


def golden_stats(x: np.ndarray) -> dict:
    x = x.astype(np.float64)
    return dict(com_x=float(x[:, 0].mean()), com_y=float(x[:, 1].mean()),
                std_x=float(x[:, 0].std()), front=float(x[:, 0].max()))


def kernel_counts():
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    return {**tk.LAUNCHES, **tk3.LAUNCHES}


def reset_counts():
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    tk.reset_launches()
    tk3.reset_launches()


def general_host_checks(tag, sim, n0, mass0, card):
    """Finite state, the particle count, constant mass (diagnostics.check,
    rtol 1e-9), every particle inside the box, no transfer kernel launched
    (the general path runs none)."""
    from mpm_flip98a_tpu_torch.utils import diagnostics

    st, cfg = sim.state, sim.cfg
    finite = all(bool(torch.isfinite(t).all()) for t in (st.x, st.v, st.C, st.F, st.J))
    x = sim.positions()
    inside = bool(((x > -cfg.dx) & (x < cfg.domain_length + cfg.dx)).all())
    summary = diagnostics.check(st, mass0)
    counts = kernel_counts()
    say(f"[main:{tag}] general path, {x.shape[0]} particles, {st.x.dtype}, finite {finite}, "
        f"inside box {inside}, summary {summary}, kernel launches {counts}  [{card}]")
    check(sim.path == "general", f"{tag}: ran the {sim.path} path")
    check(finite, f"{tag}: non-finite state")
    check(x.shape[0] == n0, f"{tag}: {x.shape[0]} particles, expected {n0}")
    check(inside, f"{tag}: particle outside the box")
    check(not any(counts.values()), f"{tag}: a transfer kernel ran on the general path")
    return summary


def general_cli(dev, card, io_ok, scenario, n_frames, n_sub):
    """A scenario through the CLI with the default (general) path, or
    through Simulation stepping frame by frame where no frame writer exists.
    Returns (sim, seconds, x after each frame)."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.utils import io_vtk

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    frames = []
    try:
        argv = ["--scenario", scenario, "--frames", str(n_frames), "--substeps", str(n_sub),
                "--no-gif", "--out", out_dir, "--device", "cuda"]
        reset_counts()
        t0 = time.perf_counter()
        if io_ok:
            sim = driver.main(argv)
            frames = [io_vtk.read_vtk_points(os.path.join(sim.vtk_dir, f"{k:05d}.vtk"))
                      for k in range(1, n_frames + 1)]
        else:
            p, scene = driver.SCENARIOS[scenario]()
            sim = driver.Simulation(p, scene, out_dir=out_dir, device=dev)
            for _ in range(n_frames):
                sim.step_frame(n_sub)
                frames.append(sim.positions())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n = n_frames * n_sub
    say(f"[main:general {scenario}] {'CLI ' + ' '.join(argv) if io_ok else 'Simulation'} in "
        f"{secs:.2f} s: {sim.stats.substeps} substeps, path {sim.path}, substeps timer "
        f"{1e3 * sim.timers.total['substeps'] / n:.4f} ms/substep (host clock, synchronised; "
        f"CUDA events {1e3 * sim.timers.device_total['substeps'] / n:.4f})  [{card}]")
    check(sim.stats.substeps == n, f"{scenario}: {sim.stats.substeps} substeps")
    return sim, secs, [f[:, :sim.cfg.dim] for f in frames]


def field_errors(got, want, names=None, scales=None) -> dict:
    """Per field of two Particles (`want` on any device): max |got - want|
    over the field's largest |want| (the consistency diagnostic, a position
    error, over x's; a field in `scales` over the scale given there)."""
    names = names or [f.name for f in dataclasses.fields(want)]
    scales = dict(scales or {}, consistency=float(want.x.abs().max()))
    out = {}
    for n in names:
        g = getattr(got, n).to(torch.float64).cpu()
        w = getattr(want, n).to(torch.float64).cpu()
        diff = float((g - w).abs().max())
        scale = scales[n] if n in scales else float(w.abs().max())
        out[n] = diff / scale if diff else 0.0
    return out


def ms_runs(call, n_sub, reps=3):
    """Median ms per substep of `reps` synchronised runs of `call()`
    (n_sub substeps each), and the runs."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / n_sub)
    return float(np.median(runs)), runs


def slot_ids(fast_mod, p, cfg, spec, dev):
    """Particle index of each live slot of `fast_mod.from_particles(p)`,
    in `to_host` order: the same bucketing of a copy whose Jp carries the
    index (exact in float32 below 2^24)."""
    tagged = dataclasses.replace(p, Jp=torch.arange(p.n, dtype=torch.float64))
    b = fast_mod.from_particles(tagged, cfg, spec, dev)
    return fast_mod.to_host(b)["Jp"].astype(np.int64)


def general_vs_fast(tag, p, scene, dev, card, n_time=20, profile_dir=None):
    """One substep of the general path and of the fast path (kernels on)
    from the same particles at t = 0: x and v slot for slot; then ms per
    substep of both (median of 3 x n_time) and their peak device memory;
    with `profile_dir`, the general path's device busy time."""
    from mpm_flip98a_tpu_torch.models import fast2d, fast3d, stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    cfg = scene.cfg
    mod = fast3d if cfg.dim == 3 else fast2d
    spec_cls = fast3d.FastSpec3D if cfg.dim == 3 else fast2d.FastSpec
    spec = spec_cls.for_particles(cfg, p)
    pg = to_device(p, dev)
    g1 = stabilized.substep(pg, scene)
    b = mod.from_particles(p, cfg, spec, dev)
    run = (lambda s, n: fast3d.run(s, scene, spec, n)) if cfg.dim == 3 else (
        lambda s, n: fast2d.run(s, scene, spec, n))
    reset_counts()
    b1 = run(b, 1)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_counts().items() if v}
    h = mod.to_host(b1)
    ids = slot_ids(mod, p, cfg, spec, dev)
    d = cfg.dim
    xg, vg = g1.x.cpu().numpy()[ids], g1.v.cpu().numpy()[ids]
    xf = np.stack([h[f"x{a}"] for a in range(d)], -1)
    vf = np.stack([h[f"v{a}"] for a in range(d)], -1)
    err = {"x": float(np.abs(xf.astype(np.float64) - xg).max()),
           "v": float(np.abs(vf.astype(np.float64) - vg).max())}
    say(f"[main:general_vs_fast {tag}] {p.n} particles, grid {cfg.num_grids}^{d}, "
        f"{p.x.dtype}: one substep general vs fast (kernels {launched}): max |dx| "
        f"{err['x']!r} (bound {VS_FAST_TOL['x']}), max |dv| {err['v']!r} (bound "
        f"{VS_FAST_TOL['v']})  [{card}]")
    check(len(ids) == p.n and sorted(ids.tolist()) == list(range(p.n)), f"{tag}: slot ids")
    check(bool(launched), f"{tag}: the fast path launched no kernel")
    for k in err:
        check(err[k] <= VS_FAST_TOL[k], f"{tag}: general vs fast {k} {err[k]:.3e}")
    del b1, g1
    out = {"x_err": err["x"], "v_err": err["v"]}
    for path, call in (("general", lambda: stabilized.run(pg, scene, n_time)),
                       ("fast", lambda: run(b, n_time))):
        call()                       # warm-up (and the first rebucket check)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, runs = ms_runs(call, n_time)
        peak = torch.cuda.max_memory_allocated()
        say(f"[timing:general_vs_fast {tag}] {path} path: {ms:.4f} ms/substep (median of 3 x "
            f"{n_time}; runs {[round(r, 4) for r in runs]}), peak device memory {peak} bytes = "
            f"{peak / 2**30:.3f} GiB  [{card}]")
        out[f"{path}_ms"], out[f"{path}_peak_bytes"] = ms, peak
    if profile_dir:
        out["general_busy_ms"] = profile_calls(
            os.path.join(profile_dir, f"profile_general_{tag}.txt"),
            lambda n: stabilized.run(pg, scene, n), n_time, out["general_ms"],
            f"general {tag}", card)
    return out


def card_vs_cpu(tag, state, scene, bounds, card, scales=None):
    """One general substep from `state` (on the card) on the card twice and
    on the CPU: the card against the CPU and the two card runs, each field
    of `bounds` within its share of its scale (`field_errors`)."""
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    a = stabilized.substep(state, scene)
    b = stabilized.substep(state, scene)
    c = stabilized.substep(to_device(state, "cpu"), scene)
    e_cpu, e_rerun = field_errors(a, c, scales=scales), field_errors(b, a, scales=scales)
    over = {n: (e_cpu[n], e_rerun[n]) for n, tol in bounds.items()
            if max(e_cpu[n], e_rerun[n]) > tol}
    say(f"[main:general_vs_cpu {tag}] {state.n} particles, {state.x.dtype}: one substep, card "
        f"vs CPU per field {e_cpu}; card rerun vs card {e_rerun}; bounds {bounds}  [{card}]")
    check(not over, f"{tag}: card vs CPU or rerun over the bound: {over}")
    return {"cpu_err": e_cpu, "rerun_err": e_rerun,
            "rerun_bitwise_equal": all(torch.equal(getattr(a, n), getattr(b, n)) for n in bounds)}


def mls88_phase(dev, card):
    """The validation model on the card against the port on the CPU: one
    substep from each warm-up state (float32), then 300 float64 substeps;
    ms per substep."""
    from mpm_flip98a_tpu_torch.config import MLS88Config
    from mpm_flip98a_tpu_torch.models import mls_mpm
    from mpm_flip98a_tpu_torch.state import to_device

    cfg = MLS88Config()
    errs = {}
    reset_counts()
    for dtype in (torch.float32, torch.float64):
        s = mls_mpm.init_dam_break(cfg=cfg, dtype=dtype, device="cpu")
        done = 0
        for w in MLS_WARMUPS:
            s = mls_mpm.run(s, cfg, w - done)
            done = w
            got = mls_mpm.substep(to_device(s, dev), cfg)
            want = mls_mpm.substep(s, cfg)
            for k in ("x", "v", "F", "C", "Jp"):
                g, t = getattr(got, k).cpu().double(), getattr(want, k).double()
                scale = float(t.abs().max()) if dtype == torch.float32 else 1.0
                errs[f"{str(dtype)[6:]} w{w} {k}"] = float((g - t).abs().max()) / scale
    p64 = mls_mpm.init_dam_break(cfg=cfg, dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    got = mls_mpm.run(to_device(p64, dev), cfg, 300)
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    want = mls_mpm.run(p64, cfg, 300)
    traj = max(float((getattr(got, k).cpu() - getattr(want, k)).abs().max()) for k in ("x", "v"))
    p32 = to_device(mls_mpm.init_dam_break(cfg=cfg, device="cpu"), dev)
    mls_mpm.run(p32, cfg, 10)
    ms32, runs32 = ms_runs(lambda: mls_mpm.run(p32, cfg, 200), 200)
    p64 = to_device(p64, dev)
    ms64, runs64 = ms_runs(lambda: mls_mpm.run(p64, cfg, 200), 200)
    say(f"[main:mls88] MLS88Config(), init_dam_break ({s.n} particles, {cfg.num_nodes}^2 "
        f"nodes): one substep card vs CPU after warm-ups {MLS_WARMUPS}, float32 (share of each "
        f"field's scale) and float64 (absolute): {errs} (bound {MLS_TOL}); 300 float64 "
        f"substeps in {traj_s:.2f} s, card vs CPU x, v {traj!r} (bound {MLS_TRAJ_TOL}); {ms32:.4f} ms/substep float32, {ms64:.4f} float64 "
        f"(median of 3 x 200; runs {[round(r, 4) for r in runs32]}, "
        f"{[round(r, 4) for r in runs64]})  [{card}]")
    check(max(errs.values()) <= MLS_TOL, f"mls88: card vs CPU {errs}")
    check(traj <= MLS_TRAJ_TOL, f"mls88: float64 trajectory {traj:.3e}")
    check(not any(kernel_counts().values()), "mls88: a transfer kernel ran")
    return {"substep_err": errs, "trajectory300_f64_err": traj, "ms_f32": ms32, "ms_f64": ms64}


def general_phases(dev, card, io_ok, profile_dir=None):
    """main:general2d, main:general_vs_cpu, main:general_vs_fast,
    main:general3d, main:mls88; fills GENERAL.  With `profile_dir`, the
    general path's device busy time on the reference scene (after its
    30,000 substeps), bench 1M, stab1M and slab 1M."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast3d, scenes, stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    # ---- main:general2d: the reference workload through the CLI ----------
    p_ref, _ = driver.SCENARIOS["dam2d"]()
    mass0 = float(p_ref.mass.sum())
    n_frames, frame = len(GOLDEN_REFERENCE), min(GOLDEN_REFERENCE)
    sim, secs, frames = general_cli(dev, card, io_ok, "dam2d", n_frames, frame)
    worst = 0.0
    for (steps, want), x in zip(sorted(GOLDEN_REFERENCE.items()), frames):
        got = golden_stats(x)
        dev_ = {k: abs(got[k] - v) for k, v in want.items()}
        worst = max(worst, *dev_.values())
        say(f"[main:general2d] after {steps} substeps: {got} against the golden {want}: "
            f"|diff| {dev_} (bound {GOLDEN_TOL})  [{card}]")
        check(max(dev_.values()) < GOLDEN_TOL, f"general2d: golden statistics at {steps}")
    final = golden_stats(sim.state.x.cpu().numpy())
    last = golden_stats(frames[-1])
    check(all(abs(final[k] - last[k]) < 1e-7 for k in final), "general2d: last frame's file")
    summary = general_host_checks("general2d", sim, p_ref.n, mass0, card)
    n_sub = n_frames * frame
    GENERAL["general2d"] = {
        "substeps": n_sub, "dtype": str(sim.state.x.dtype), "golden_worst_abs_diff": worst,
        "ms_per_substep": 1e3 * sim.timers.total["substeps"] / n_sub,
        "device_ms_per_substep": 1e3 * sim.timers.device_total["substeps"] / n_sub,
        "seconds": secs, "j_min": summary["j_min"], "j_max": summary["j_max"]}
    if profile_dir:
        GENERAL["general2d"]["busy_ms"] = profile_calls(
            os.path.join(profile_dir, "profile_general_reference.txt"),
            lambda n: stabilized.run(sim.state, sim.scene, n), 200,
            GENERAL["general2d"]["ms_per_substep"], "general reference", card)
    state_1k = stabilized.run(to_device(p_ref, dev), sim.scene, 1000)
    del sim
    for scenario in ("elastic_drop", "dam2d_obstacle"):
        p0, _ = driver.SCENARIOS[scenario]()
        sim, secs, _ = general_cli(dev, card, io_ok, scenario, 1, 200)
        general_host_checks(f"general {scenario}", sim, p0.n, float(p0.mass.sum()), card)
        entry = {"ms_per_substep": 1e3 * sim.timers.total["substeps"] / 200}
        if sim.scene.colliders:
            depth = penetration(sim)
            say(f"[main:general {scenario}] deepest particle inside a collider {depth:.3f} dx "
                f"(bound 1.5)  [{card}]")
            check(depth < 1.5, f"general {scenario}: a particle {depth:.3f} dx inside")
            entry["collider_depth_dx"] = depth
        GENERAL[scenario] = entry
    say("[timing] general 2D phases done")

    # ---- main:general_vs_cpu --------------------------------------------------
    every = {f.name: GENERAL_TOL[torch.float64] for f in dataclasses.fields(state_1k)}
    GENERAL["vs_cpu_reference_1000"] = card_vs_cpu("reference after 1000", state_1k,
                                                   driver.SCENARIOS["dam2d"]()[1], every, card)
    cfg37 = MPMConfig(**STAB37, transfer=TransferKind.PIC)
    p37, scene37 = scenes.dam_break_2d(cfg37, dtype=np.float32)
    s37 = stabilized.run(to_device(p37, dev), scene37, 200)
    GENERAL["vs_cpu_stab37"] = card_vs_cpu("stab1M set at 37^2 after 200", s37, scene37,
                                           CARRIED, card)
    del state_1k, s37

    # ---- main:general_vs_fast -----------------------------------------------
    for tag, cfg in (("bench1M", MPMConfig(**BENCH, transfer=TransferKind.PIC)),
                     ("stab1M", MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC))):
        p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
        GENERAL[f"vs_fast_{tag}"] = general_vs_fast(tag, p, scene, dev, card,
                                                    profile_dir=profile_dir)
        torch.cuda.empty_cache()

    # ---- main:general3d ---------------------------------------------------------
    p3, _ = driver.SCENARIOS["dam3d"]()
    sim, secs, _ = general_cli(dev, card, io_ok, "dam3d", 2, 100)
    general_host_checks("general dam3d", sim, p3.n, float(p3.mass.sum()), card)
    GENERAL["dam3d"] = {"ms_per_substep": 1e3 * sim.timers.total["substeps"] / 200}
    del sim
    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    GENERAL["vs_fast_slab1M"] = general_vs_fast("slab1M", p1, scene1, dev, card, n_time=5,
                                                profile_dir=profile_dir)
    del p1
    torch.cuda.empty_cache()

    # ---- main:mls88 ---------------------------------------------------------------
    GENERAL["mls88"] = mls88_phase(dev, card)
    say(json.dumps({"general": GENERAL}))


# ---------------------------------------------------------------------------
# Plasticity: snow, Drucker-Prager sand and the corotated clamp
# ---------------------------------------------------------------------------

# The snow and sand scenes at a user's high resolution: the reference's
# 105^2 grid refined 20x (2049^2), each scene at its own particle spacing
# (snow 800^2 = 640,000; sand 560 x 1520 = 851,200), float32, dt 1e-6;
# and drop3d with a sand block.
PLASTIC_GRID = 2049
PLASTIC_2K = {"snow2k": dict(particles_per_axis=800),
              "sand2k": dict(particles_per_axis=(560, 1520))}
# tests/test_sand.py:174-199: the column at 37^2 (dt 5e-5, 12 x 30
# particles) settles into a steeper, narrower pile at 45 degrees than at 15.
FRICTION = dict(num_grids=37, dt=5e-5, particles_per_axis=(12, 30), angles=(15.0, 45.0),
                substeps=4000)
PLASTIC = {}                 # the {"plastic": ...} line


def plastic_host_checks(tag, sim, n0, mass0, card):
    """Phase 4's host checks on the fast path, the general path's on the
    general one, and Jp within the clamp bounds [0.6, 20]."""
    from mpm_flip98a_tpu_torch.models import fast2d, fast3d

    if sim.path == "general":
        general_host_checks(tag, sim, n0, mass0, card)
        jp = sim.state.Jp.double().cpu().numpy()
    else:
        host_checks(tag, sim, n0, mass0, card)
        jp = (fast3d if sim.cfg.dim == 3 else fast2d).to_host(sim.state)["Jp"]
    lo, hi = sim.scene.params.jp_clamp_lo, sim.scene.params.jp_clamp_hi
    say(f"[main:{tag}] Jp range [{float(jp.min())!r}, {float(jp.max())!r}] (bounds [{lo}, {hi}]), "
        f"Jp moved off 1 on {float((np.abs(jp - 1.0) > 1e-6).mean()):.4f} of the particles  "
        f"[{card}]")
    check(bool(np.isfinite(jp).all()) and jp.min() >= lo - 1e-6 and jp.max() <= hi + 1e-6,
          f"{tag}: Jp left [{lo}, {hi}]")


def plastic_cli(dev, card, io_ok, scenario, path, n_frames, n_sub):
    """`scenario` through the CLI on `path` (Simulation where no frame
    writer exists): on the fast path p2g and g2p once per substep and
    p2g_fused never, on the general path no kernel; the host checks."""
    from mpm_flip98a_tpu_torch import driver

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        argv = ["--scenario", scenario, "--path", path, "--frames", str(n_frames), "--substeps",
                str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda"]
        p0, _ = driver.SCENARIOS[scenario]()
        reset_counts()
        t0 = time.perf_counter()
        if io_ok:
            sim = driver.main(argv)
        else:
            p, scene = driver.SCENARIOS[scenario]()
            sim = driver.Simulation(p, scene, path=path, out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernel_counts()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n = n_frames * n_sub
    say(f"[main:plastic {scenario} {path}] {'CLI ' + ' '.join(argv) if io_ok else 'Simulation'} "
        f"in {secs:.2f} s: {sim.stats.substeps} substeps, launches {got}, "
        f"{1e3 * sim.timers.total['substeps'] / n:.4f} ms/substep (host clock, synchronised)  "
        f"[{card}]")
    check(sim.stats.substeps == n, f"{scenario} {path}: {sim.stats.substeps} substeps")
    if path == "fast":
        check(got["p2g"] == got["g2p"] == n and got["p2g_fused"] == 0,
              f"{scenario} fast: launches {got} for {n} substeps")
        mass0 = float(p0.mass.to(torch.float32).double().sum())
    else:
        mass0 = float(p0.mass.sum())
    plastic_host_checks(f"plastic {scenario} {path}", sim, p0.n, mass0, card)
    return {"ms_per_substep": 1e3 * sim.timers.total["substeps"] / n, "launches": got}


def rerun_bitwise(tag, p, scene, dev, n_sub, card):
    """Two n_sub-substep fast 2D runs from the same bucket state: every
    field bitwise equal (every 2D kernel and the glue sum in a fixed
    order)."""
    from mpm_flip98a_tpu_torch.models import fast2d

    spec = fast2d.FastSpec.for_particles(scene.cfg, p)
    b0 = fast2d.from_particles(p, scene.cfg, spec, dev)
    a = fast2d.run(b0, scene, spec, n_sub)
    b = fast2d.run(b0, scene, spec, n_sub)
    differ = [f.name for f in dataclasses.fields(a) if not torch.equal(getattr(a, f.name),
                                                                        getattr(b, f.name))]
    say(f"[main:plastic rerun {tag}] {p.n} particles, two {n_sub}-substep fast runs: fields "
        f"not bitwise equal {differ}  [{card}]")
    check(not differ, f"{tag}: two fast 2D runs differ in {differ}")
    return not differ


def friction_check(dev, card):
    """tests/test_sand.py:174-199 on the card through the fast path: the
    pile at 45 degrees is higher (h > 1.2 h) and narrower (w < 0.8 w) than
    at 15, after 4000 substeps each; finite, in the box, slumped."""
    from mpm_flip98a_tpu_torch.config import MPMConfig
    from mpm_flip98a_tpu_torch.models import fast2d, scenes

    cfg = MPMConfig(dtype="float32", num_grids=FRICTION["num_grids"], dt=FRICTION["dt"])
    out = {}
    for phi in FRICTION["angles"]:
        p, scene = scenes.sand_column_2d(cfg, dtype=np.float32,
                                         particles_per_axis=FRICTION["particles_per_axis"],
                                         friction_angle=phi)
        spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
        stats = fast2d.RunStats()
        t0 = time.perf_counter()
        b = fast2d.run(fast2d.from_particles(p, cfg, spec, dev), scene, spec,
                       FRICTION["substeps"], stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        h = fast2d.to_host(b)
        x = np.stack([h["x0"], h["x1"]], -1)
        l = cfg.domain_length
        ok = (bool(np.isfinite(x).all()) and bool(((x > -cfg.dx) & (x < l + cfg.dx)).all())
              and int(b.overflow) == 0 and x.shape[0] == p.n)
        slumped = float(x[:, 1].max()) < 0.5 * float(p.x[:, 1].max())
        out[phi] = {"height": float(x[:, 1].max()), "width": float(np.ptp(x[:, 0])),
                    "ms_per_substep": 1e3 * secs / FRICTION["substeps"]}
        say(f"[main:plastic friction] phi {phi}: {FRICTION['substeps']} substeps in {secs:.2f} s "
            f"({stats.rebuckets} rebuckets): pile height {out[phi]['height']!r}, width "
            f"{out[phi]['width']!r}; finite, in the box, no overflow {ok}; slumped {slumped}  "
            f"[{card}]")
        check(ok and slumped, f"friction: phi {phi} state")
    (lo, hi) = (out[a] for a in FRICTION["angles"])
    say(f"[main:plastic friction] h45 / h15 = {hi['height'] / lo['height']:.4f} (bound > 1.2), "
        f"w45 / w15 = {hi['width'] / lo['width']:.4f} (bound < 0.8)  [{card}]")
    check(hi["height"] > 1.2 * lo["height"], "friction: the 45-degree pile is not steeper")
    check(hi["width"] < 0.8 * lo["width"], "friction: the 45-degree pile is not narrower")
    return out


def plastic2k(tag, dev, card, err, kernel_ms, plain_ms, bounds, launches):
    """snow2k or sand2k through Simulation on the fast path (2 frames x 100
    substeps): launches, host checks, peak memory; p2g and g2p against
    their plain versions on the final state, p2g's reruns, CUDA-event times
    and bounds; ms per substep (3 x 20); one substep fast against general;
    for sand2k two 100-substep runs bitwise equal."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    cfg = MPMConfig(dtype="float32", num_grids=PLASTIC_GRID)
    build = scenes.snow_block_2d if tag == "snow2k" else scenes.sand_column_2d
    p, scene = build(cfg, dtype=np.float32, **PLASTIC_2K[tag])
    mass0 = float(p.mass.to(torch.float32).double().sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    sim.run(2, 100, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[main:plastic {tag}] {p.n} particles, grid {cfg.num_grids}^2, materials "
        f"{scene.materials_present}, buckets {tuple(sim.state.shape)}; Simulation 2 frames x "
        f"100 substeps in {time.perf_counter() - t0:.2f} s, launches {got}, peak device memory "
        f"{peak} bytes = {peak / 2**30:.3f} GiB  [{card}]")
    check(got["p2g"] == got["g2p"] == 200 and got["p2g_fused"] == 0,
          f"{tag}: launches {got} for 200 substeps")
    for name in ("p2g", "g2p"):
        launches[f"{tag}_{name}"] = got[name]
    plastic_host_checks(f"plastic {tag}", sim, p.n, mass0, card)

    pdata, pdata2, counts = fast2d.transfer_inputs(sim.state, scene)
    args = fast2d.p2g_args(scene)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    grid = fast2d._grid_update2d(tk.fold_rows(tk.p2g(pdata, counts, **args)), scene)
    err[f"{tag}_p2g"], err[f"{tag}_g2p"] = compare_prepped(
        tag, pdata, pdata2, counts, grid, args, dinv, card)
    rerun_equal(f"main:plastic {tag}", "p2g", lambda: tk.p2g(pdata, counts, **args), card)
    r, nrows, k = pdata.shape
    nch, live, g = nrows - 8, int(counts.sum()), cfg.num_grids
    # g2p reads only the grid rows that live slots' taps reach (the block
    # covers a fifth of the rows at most): count those, not all R.
    on = (pdata2[:, 2] > 0) & (torch.arange(k, device=dev)[None, :] < counts[:, None])
    base0 = torch.floor(pdata2[:, 0][on] - 0.5).long()
    rows = int(torch.unique(torch.cat([base0 + j for j in range(3)]).clamp(0, r - 1)).numel())
    bounds[f"{tag}_p2g"] = bound(4 * ((8 + nch) * live + r + 5 * nch * r * g), live * 9 * nch * 2)
    bounds[f"{tag}_g2p"] = bound(4 * (3 * live + r + 4 * rows * g + 8 * r * k), live * 9 * 8 * 2)
    pairs = {f"{tag}_p2g": (lambda: tk.p2g(pdata, counts, **args),
                            lambda: tk.p2g_plain(pdata, counts, **args)),
             f"{tag}_g2p": (lambda: tk.g2p(pdata2, counts, grid, args["dx"], dinv),
                            lambda: tk.g2p_plain(pdata2, counts, grid, args["dx"], dinv))}
    for name, (call, plain_call) in pairs.items():
        kernel_ms[name] = cuda_ms(call)
        plain_ms[name] = cuda_ms(plain_call, reps=5, warm=1)
        say(f"[main:plastic {tag}] {name} (buckets {r}x{k}, {live} live, {nch} channels): "
            f"kernel {kernel_ms[name]:.4f} ms (CUDA events, 20 calls), plain "
            f"{plain_ms[name]:.4f} ms (5 calls), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{card}]")
    del pdata, pdata2, counts, grid, pairs
    step = lambda s: fast2d.substep(s, scene)
    wall = time_paths(f"plastic {tag}", fast2d, sim.state, scene, sim.spec, step, p.n,
                      cfg.stencil_size, 20, 3, card)
    out = {"particles": p.n, "ms_per_substep": 1e3 * wall, "peak_bytes": peak,
           "vs_general": general_vs_fast(tag, p, scene, dev, card)}
    if tag == "sand2k":
        out["rerun_bitwise_equal"] = rerun_bitwise(tag, p, scene, dev, 100, card)
    del sim
    torch.cuda.empty_cache()
    return out


def sanddrop3d(dev, card, err, kernel_ms, plain_ms, bounds, launches):
    """drop3d's scene with a sand block through Simulation (2 frames x 10
    substeps): launches, host checks, peak memory; p2g3d_grid's prepped
    mode and g2p3d's gather mode against plain on its state (with p2g3d
    beside them), times and bounds; ms per substep (3 x 5); one substep
    fast against general."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import fast3d, materials as mat, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    p, scene = scenes.elastic_drop_3d(**DROP_3D, block_material=mat.SAND)
    mass0 = float(p.mass.to(torch.float32).double().sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    sim.run(2, 10, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[main:plastic sanddrop3d] elastic_drop_3d {DROP_3D} with a sand block: {p.n} "
        f"particles, materials {scene.materials_present}, buckets {tuple(sim.state.shape)}; "
        f"Simulation 2 frames x 10 substeps in {time.perf_counter() - t0:.2f} s, launches {got}, "
        f"peak device memory {peak} bytes = {peak / 2**30:.3f} GiB  [{card}]")
    check(got["p2g3d_grid"] == got["g2p3d"] == 20 and got["p2g3d"] == 0,
          f"sanddrop3d: launches {got} for 20 substeps")
    for name in ("p2g3d_grid", "g2p3d"):
        launches[f"sanddrop3d_{name}"] = got[name]
    plastic_host_checks("plastic sanddrop3d", sim, p.n, mass0, card)
    check(bool((sim.state.F22 != 1.0).any()), "sanddrop3d: F was never updated")

    spec = sim.spec
    args = fast3d.p2g_args(scene)
    mode = (args["apic"], args["ext"], args["tent"])
    node = {n: args[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")}
    fields = fast3d.prepped_fields(sim.state, scene, spec)
    counts = fast3d.pencil_counts(sim.state)
    mask = sim.state.mask.view(spec.rows0, spec.rows1, spec.capacity)
    _, err["sanddrop3d_p2g3d_grid"], err["sanddrop3d_g2p3d"], grid = compare_prepped3d(
        "sanddrop3d", fields, counts, mask, mode, node, args["g2"], args["dx"], card)
    r0, r1, k3 = mask.shape
    live, n_in = int(counts.sum()), len(fields)
    nodes = (r0 + 4) * (r1 + 4) * args["g2"]
    dinv = float(4.0 * scene.cfg.inv_dx * scene.cfg.inv_dx)
    g2p_in = (*fields[:3], mask, counts, grid, args["dx"], dinv)
    bounds["sanddrop3d_p2g3d_grid"] = bound(4 * (n_in * live + r0 * r1 + tk3.G2P_CH * nodes),
                                            live * 27 * tk3.P2G_CH * 2)
    bounds["sanddrop3d_g2p3d"] = bound(
        4 * (4 * live + r0 * r1 + tk3.G2P_CH * nodes + 15 * r0 * r1 * k3), live * 27 * 15 * 2)
    pairs = {"sanddrop3d_p2g3d_grid": (lambda: tk3.p2g3d_grid(fields, counts, r1, **args),
                                       lambda: tk3.p2g3d_grid_plain(fields, counts, r1, **args)),
             "sanddrop3d_g2p3d": (lambda: tk3.g2p3d(*g2p_in), lambda: tk3.g2p3d_plain(*g2p_in))}
    for name, (call, plain_call) in pairs.items():
        kernel_ms[name] = cuda_ms(call, reps=10, warm=2)
        plain_ms[name] = cuda_ms(plain_call, reps=2, warm=1)
        say(f"[main:plastic sanddrop3d] {name} ({n_in} planes, buckets {r0}x{r1}x{k3}, {live} "
            f"live): kernel {kernel_ms[name]:.4f} ms (CUDA events, 10 calls), plain "
            f"{plain_ms[name]:.4f} ms (2 calls), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{card}]")
    del fields, counts, mask, grid, g2p_in, pairs
    # The plastic update on the live sand slots alone (fast3d._slots_of)
    # against the same update on every slot, as the reference computes it.
    st = sim.state
    fm = fast3d._fmat(st)
    idx = fast3d._slots_of(st, (mat.SAND,))
    f_all, f_live = fast3d._fmat3(fm), fast3d._fmat3([f[idx] for f in fm])
    update = lambda m, f, jp: mat.plastic_update(scene.params, m, f, jp, scene.materials_present)
    svd_ms = {"all_slots": cuda_ms(lambda: update(st.mat, f_all, st.Jp), reps=3, warm=1),
              "live_sand_slots": cuda_ms(lambda: update(st.mat[idx], f_live, st.Jp[idx]),
                                         reps=3, warm=1)}
    say(f"[main:plastic sanddrop3d] plastic_update on all {f_all.shape[0] * f_all.shape[1]} "
        f"slots {svd_ms['all_slots']:.4f} ms, on the {f_live.shape[0]} live sand slots "
        f"{svd_ms['live_sand_slots']:.4f} ms (CUDA events, 3 calls)  [{card}]")
    del st, fm, idx, f_all, f_live
    torch.cuda.empty_cache()
    step = lambda s: fast3d.substep(s, scene, spec)
    wall = time_paths("plastic sanddrop3d", fast3d, sim.state, scene, spec, step, p.n, 27, 5, 3,
                      card)
    del sim
    torch.cuda.empty_cache()
    return {"particles": p.n, "ms_per_substep": 1e3 * wall, "peak_bytes": peak,
            "plastic_update_ms": svd_ms,
            "vs_general": general_vs_fast("sanddrop3d", p, scene, dev, card, n_time=5)}


def plastic_phases(dev, card, io_ok, err, kernel_ms, plain_ms, bounds, launches):
    """Phase 35, main:plastic; fills PLASTIC and prints its line."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import scenes, stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    t0 = time.perf_counter()
    for scenario in ("snow2d", "sand2d"):
        for path in ("fast", "general"):
            PLASTIC[f"{scenario}_{path}"] = plastic_cli(dev, card, io_ok, scenario, path, 2, 200)
    for scenario in ("snow2d", "sand2d"):
        p, scene = driver.SCENARIOS[scenario]()
        state = stabilized.run(to_device(p, dev), scene, 200)
        every = {f.name: GENERAL_TOL[torch.float64] for f in dataclasses.fields(state)}
        # After 200 substeps both bodies still fall as a whole: C and its
        # trace are rounding residues of sums whose terms are dinv dx |v|
        # in size, so that is their scale (as g2p's C in compare_g2p).
        term = 4.0 * float(state.v.abs().max()) / scene.cfg.dx
        PLASTIC[f"{scenario}_vs_cpu"] = card_vs_cpu(f"{scenario} after 200", state, scene,
                                                    every, card, {"C": term, "div_v": term})
    say(f"[timing] plastic CLIs done in {time.perf_counter() - t0:.1f} s")
    for tag in PLASTIC_2K:
        PLASTIC[tag] = plastic2k(tag, dev, card, err, kernel_ms, plain_ms, bounds, launches)
    p, scene = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC), dtype=np.float32)
    PLASTIC["bench1M_rerun_bitwise_equal"] = rerun_bitwise("bench1M", p, scene, dev, 100, card)
    del p
    say(f"[timing] plastic 2D scenes done in {time.perf_counter() - t0:.1f} s")
    PLASTIC["sanddrop3d"] = sanddrop3d(dev, card, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] sanddrop3d done in {time.perf_counter() - t0:.1f} s")
    PLASTIC["friction"] = friction_check(dev, card)
    say(f"[timing] plastic phases done in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"plastic": PLASTIC}))


# ---------------------------------------------------------------------------
# CSF surface tension and the incompressible projection
# ---------------------------------------------------------------------------

# The zero-gravity 2:1 drop of tests/test_surface_tension.py:19-52 (41^2,
# 32 x 16 particles, dt 5e-5, sigma 5).  csf513 is that drop on 513^2 at
# the same particle spacing in cells (32 x 508 / 36 = 452 across) and the
# bench's dt there.
DROP41 = dict(num_grids=41, dt=5e-5, particles=(32, 16))
CSF513 = dict(num_grids=513, dt=2e-6)
# Shards against one device after one projected substep, v and C over
# their max.  At 129^2 and 513^2 the CG stops at its 60-iteration cap with
# |r| about |b| (exit resid 1.12-1.19 on the CPU), so q carries the
# iteration's rounding: dot products summed per shard and then over the
# shards move v by 7e-6 to 1.2e-5 and C by 2e-5 to 3.6e-5 of their max
# (read on the CPU, bench 1M and its 129^2 cut), past KERNEL_REL_TOL.
# `halo_fault` reads the same gate with one stale halo row in the CG and
# fails unless that reading is above the bound.
INCOMP_SHARD_TOL = 1e-4
# The collider scenes' spheres moved against the column's edge (2D column
# to 0.129 l, sphere radius 0.08 l; 3D column to 0.245 l, radius 0.1 l).
TOUCHING = {"dam2d_obstacle": (0.21, 0.10), "dam3d_obstacle": (0.35, 0.12, 0.12)}
INCOMP = {}                  # the {"incompressible": ...} line


class CGProbe:
    """Inside `with`: every call of models.projection.project_planes keeps
    its exit residual (a device tensor, read after the window) and, with
    `check_every`, reads its active flag at that interval
    (projection.CHECK_EVERY)."""

    def __init__(self, check_every=None):
        self.check_every, self.resids = check_every, []

    def __enter__(self):
        from mpm_flip98a_tpu_torch.models import projection

        self.real, self.every = projection.project_planes, projection.CHECK_EVERY
        if self.check_every is not None:
            projection.CHECK_EVERY = self.check_every

        def probed(*a, **k):
            out = self.real(*a, **k)
            self.resids.append(out[2])
            return out

        projection.project_planes = probed
        return self

    def __exit__(self, *exc):
        from mpm_flip98a_tpu_torch.models import projection

        projection.project_planes, projection.CHECK_EVERY = self.real, self.every

    def read(self):
        return [float(r) for r in self.resids]


def halo_fault(tag, p, scene, dev, shards, card, axis=0):
    """The shards-against-one-device gate of `sharded_against_single`
    with a planted fault: every halo refresh of the projection leaves
    shard 1's lower halo row (`axis` 1: its lower axis-1 halo column, on
    the two-axis mesh) stale.  Returns v's and C's errors over their max
    after one substep; the gate must see them."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import projection

    tmp = tempfile.gettempdir()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tmp, device=dev, devices=shards)
    ref = driver.Simulation(p, scene, path="fast", out_dir=tmp, device=dev)
    real = projection.project_planes

    def faulty(*a, halo=None, **k):
        def stale(buf):
            at = (1, 0) if axis == 0 else (1, slice(None), 0)
            keep = buf[at].clone()
            halo(buf)
            buf[at] = keep
            return buf

        return real(*a, halo=None if halo is None else stale, **k)

    projection.project_planes = faulty
    try:
        sim.run(1, 1, gif=False, verbose=False, write_frames=False)
    finally:
        projection.project_planes = real
    ref.run(1, 1, gif=False, verbose=False, write_frames=False)
    e1 = state_errors(global_state(sim), ref.state, scene.cfg.dim)
    say(f"[main:sharded {tag} halo fault] one stale axis-{axis} halo row in the CG: after 1 "
        f"substep v "
        f"{e1['v']:.3e} and C {e1['C']:.3e} of their max (the gate's tol "
        f"{INCOMP_SHARD_TOL})  [{card}]")
    check(min(e1["v"], e1["C"]) > INCOMP_SHARD_TOL,
          f"{tag}: the shard gate does not see a stale halo row in the CG: {e1}")
    return {"v": e1["v"], "C": e1["C"]}


def incompressible(scene):
    return dataclasses.replace(scene, cfg=dataclasses.replace(scene.cfg, incompressible=True))


def incomp_cli(dev, card, io_ok, path, devices):
    """dam2d_incompressible through the CLI (2 frames x 100): launches, the
    host checks, |J - 1| < 5e-4 on the fast path
    (tests/test_projection.py:189)."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import fast2d

    scenario, n_frames, n_sub = "dam2d_incompressible", 2, 100
    n = n_frames * n_sub
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        argv = ["--scenario", scenario, "--path", path, "--devices", str(devices), "--frames",
                str(n_frames), "--substeps", str(n_sub), "--no-gif", "--out", out_dir,
                "--device", "cuda"]
        p0, scene = driver.SCENARIOS[scenario]()
        reset_counts()
        t0 = time.perf_counter()
        with CGProbe() as probe:
            if io_ok:
                sim = driver.main(argv)
            else:
                sim = driver.Simulation(p0, scene, path=path, out_dir=out_dir, device=dev,
                                        devices=devices)
                sim.run(n_frames, n_sub, gif=False, write_frames=False)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernel_counts()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    resid = probe.read()
    tag = f"incompressible {scenario} {path} x{devices}"
    say(f"[main:{tag}] {'CLI ' + ' '.join(argv) if io_ok else 'Simulation'} in {secs:.2f} s: "
        f"{sim.stats.substeps} substeps, launches {got}, "
        f"{1e3 * sim.timers.total['substeps'] / n:.4f} ms/substep (host clock, synchronised); "
        f"CG exit resid over the run: max {max(resid)!r}, median {float(np.median(resid))!r}  "
        f"[{card}]")
    check(sim.stats.substeps == n == len(resid), f"{tag}: {sim.stats.substeps} substeps")
    out = {"ms_per_substep": 1e3 * sim.timers.total["substeps"] / n, "launches": got,
           "resid_max": max(resid)}
    if path == "general":
        general_host_checks(tag, sim, p0.n, float(p0.mass.sum()), card)
        return out
    p2g = "p2g_grid" if devices > 1 else "p2g_fused"
    check(got[p2g] == got["g2p"] == n and sum(got.values()) == 2 * n,
          f"{tag}: launches {got} for {n} substeps")
    host_checks(tag, sim, p0.n, float(p0.mass.to(torch.float32).double().sum()), card)
    j = fast2d.to_host(sim.state)["J"]
    out["J_dev"] = float(np.abs(j - 1.0).max())
    say(f"[main:{tag}] max |J - 1| {out['J_dev']!r} (bound 5e-4)  [{card}]")
    check(out["J_dev"] < 5e-4, f"{tag}: |J - 1| {out['J_dev']}")
    return out


def incomp1m(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds, launches):
    """incomp1M: bench 1M with the projection on the fast path."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.parallel import fast_domain

    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC, incompressible=True)
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    mass0 = float(p.mass.to(torch.float32).double().sum())
    tmp = tempfile.gettempdir()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tmp, device=dev)
    reset_counts()
    sim.run(1, 20, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = kernel_counts()
    check(got["p2g_fused"] == got["g2p"] == 20 and sum(got.values()) == 40,
          f"incomp1M: launches {got} for 20 substeps")
    launches["incomp1M_p2g_fused"], launches["incomp1M_g2p"] = got["p2g_fused"], got["g2p"]
    host_checks("incomp1M", sim, p.n, mass0, card)
    out = {"particles": p.n}

    # The kernels on its state against their plain versions.
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    sdata, pdata2, counts = fast2d.transfer_inputs(sim.state, scene)
    args = fast2d.p2g_args(scene)
    grid4 = fast2d._grid_update2d(tk.fold_rows(tk.p2g_fused(sdata, counts, **args)), scene)
    err["incomp1M_p2g_fused"], err["incomp1M_g2p"] = compare_kernels(
        "incomp1M", sdata, pdata2, counts, grid4, args, dinv, card)
    rerun_equal("main:incomp1M", "p2g_fused", lambda: tk.p2g_fused(sdata, counts, **args), card)
    r2, _, k2 = sdata.shape
    live2, g = int(counts.sum()), cfg.num_grids
    bounds["incomp1M_p2g_fused"] = bound(4 * (11 * live2 + r2 + r2 * 25 * g), live2 * 9 * 5 * 2)
    bounds["incomp1M_g2p"] = bound(4 * (3 * live2 + r2 + r2 * 4 * g + r2 * 8 * k2),
                                   live2 * 9 * 8 * 2)
    pairs = {"incomp1M_p2g_fused": (lambda: tk.p2g_fused(sdata, counts, **args),
                                    lambda: tk.p2g_fused_plain(sdata, counts, **args)),
             "incomp1M_g2p": (lambda: tk.g2p(pdata2, counts, grid4, args["dx"], dinv),
                              lambda: tk.g2p_plain(pdata2, counts, grid4, args["dx"], dinv))}
    for name, (call, plain_call) in pairs.items():
        kernel_ms[name] = cuda_ms(call)
        plain_ms[name] = cuda_ms(plain_call, reps=5, warm=1)
        say(f"[main:incomp1M] {name} (buckets {r2}x{k2}, {live2} live): kernel "
            f"{kernel_ms[name]:.4f} ms (CUDA events, 20 calls), plain {plain_ms[name]:.4f} ms "
            f"(5 calls), bound {bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")
    del sdata, pdata2, counts, grid4, pairs

    # ms per substep: the kernel path with the CG's active flag read every
    # 8 iterations and every iteration, interleaved, then the plain path.
    b, spec = sim.state, sim.spec
    run = lambda plain=False: fast2d.run(b, scene, spec, 20, plain=plain)
    runs = {8: [], 1: []}
    with CGProbe() as probe:
        run()
    resid = probe.read()
    for _ in range(3):
        for every in runs:
            with CGProbe(check_every=every):
                runs[every].append(ms_runs(run, 20, reps=1)[0])
    out["ms_per_substep"] = float(np.median(runs[8]))
    out["read_every_iteration_ms_per_substep"] = float(np.median(runs[1]))
    out["plain_ms_per_substep"], runs_p = ms_runs(lambda: run(plain=True), 20)
    out["cg_resid"] = {"max": max(resid), "median": float(np.median(resid)),
                       "min": min(resid), "substeps": len(resid)}
    say(f"[timing:incomp1M] kernel path {out['ms_per_substep']:.4f} ms/substep (median of 3 x 20; "
        f"runs {[round(r, 4) for r in runs[8]]}), the CG's active flag read every iteration "
        f"instead of every 8 (interleaved with it): "
        f"{out['read_every_iteration_ms_per_substep']:.4f} "
        f"(runs {[round(r, 4) for r in runs[1]]}); "
        f"plain path {out['plain_ms_per_substep']:.4f} (runs {[round(r, 4) for r in runs_p]}); "
        f"CG exit resid over {len(resid)} substeps (read after them): {out['cg_resid']}  [{card}]")
    if profile_dir:
        out["busy_ms"] = profile_calls(
            os.path.join(profile_dir, "profile_incomp1M.txt"),
            lambda n: fast2d.run(b, scene, spec, n), 5, out["ms_per_substep"], "incomp1M", card)
    del sim, b
    torch.cuda.empty_cache()

    # One substep against the general path, then two 100-substep runs.
    out["vs_general"] = general_vs_fast("incomp1M", p, scene, dev, card, n_time=3)
    spec = fast2d.FastSpec.for_particles(cfg, p)
    b0 = fast2d.from_particles(p, cfg, spec, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = fast2d.run(b0, scene, spec, 100)
    c = fast2d.run(b0, scene, spec, 100)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    differ = [f.name for f in dataclasses.fields(a)
              if not torch.equal(getattr(a, f.name), getattr(c, f.name))]
    out["rerun_bitwise_equal"] = not differ
    out["J_dev_100"] = float((a.J - 1.0).abs().max())
    say(f"[main:incomp1M rerun] two 100-substep runs: fields not bitwise equal {differ}; max "
        f"|J - 1| after 100 substeps {out['J_dev_100']!r}; peak device memory "
        f"{out['peak_bytes']} bytes = {out['peak_bytes'] / 2**30:.3f} GiB  [{card}]")
    check(not differ, f"incomp1M: two fast runs differ in {differ}")
    check(out["J_dev_100"] < 5e-4, f"incomp1M: |J - 1| {out['J_dev_100']}")
    del a, c, b0
    torch.cuda.empty_cache()

    # 4 slab shards against one device, then p2g_grid on the sharded state.
    shards = 4
    sim, ref, got = sharded_against_single("incomp1M", p, scene, dev, shards, 10, card,
                                           INCOMP_SHARD_TOL)
    check(got["p2g_grid"] == got["p2g_fused"] == 10 and got["g2p"] == 20,
          f"sharded incomp1M: launches {got}")
    # The sharded run alone, counted: one p2g_grid and one g2p per substep.
    reset_counts()
    sim.step_frame(10)
    torch.cuda.synchronize()
    got = kernel_counts()
    launches["incomp1Mx4_p2g_grid"], launches["incomp1Mx4_g2p"] = got["p2g_grid"], got["g2p"]
    say(f"[main:incomp1M x4] the sharded run alone, 10 substeps: launches {got}")
    check(got["p2g_grid"] == got["g2p"] == 10 and sum(got.values()) == 20,
          f"sharded incomp1M: launches {got} for 10 substeps of the sharded run alone")
    out["shard_gate_halo_fault"] = halo_fault("incomp1M", p, scene, dev, shards, card)
    ctx = fast_domain.FastDomainCtx(sim.mesh, sim.spec.rows_per_shard)
    data, pdata2, counts = fast2d.transfer_inputs(sim.state, scene, ctx)
    kw = {n: v for n, v in fast2d.p2g_args(scene).items() if n not in ("g", "dx")}
    kw["fused"] = True
    dx = float(cfg.dx)
    err["incomp1Mx4_p2g_grid"], raw = compare_p2g_grid("incomp1M", data, counts, kw, shards, g,
                                                       dx, card)
    name = "incomp1Mx4_p2g_grid"
    kernel_ms[name] = cuda_ms(lambda: tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards,
                                                  **kw))
    plain_ms[name] = cuda_ms(lambda: tk.p2g_grid_plain(data, counts, g, dx, raw=True,
                                                       shards=shards, **kw), reps=3, warm=1)
    bounds[name] = p2g_grid_bound(data, counts, shards, raw.shape[2], g)
    grid = fast2d._grid_update2d(ctx.halo_sync(raw), scene, ctx.row_index0(dev), domain=ctx)
    err["incomp1Mx4_g2p"] = compare_g2p("main:incomp1M x4", pdata2, counts, grid, dx, dinv,
                                        False, card, prepadded=True)
    say(f"[main:incomp1M x4] p2g_grid raw {kernel_ms[name]:.4f} ms (CUDA events, 20 calls), "
        f"plain {plain_ms[name]:.4f} ms (3 calls), bound {bounds[name][0]:.4f} ms "
        f"({bounds[name][1]})  [{card}]")
    del sim, ref, data, pdata2, counts, raw, grid
    torch.cuda.empty_cache()
    return out


def incomp8m(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds, launches):
    """incomp8M: the 8M slab with the projection (p2g3d + fold_rows0 +
    _grid_update + the CG + g2p3d), its sharded form, and general against
    fast at slab 1M."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import TransferKind
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d

    p, scene = scenes.slab_3d(**SLAB_8M)
    scene = incompressible(scene)
    check(not fast3d.uses_fused(scene) and not fast3d.kernel_grid(scene),
          "incomp8M: the projection must leave the fused branch")
    mass0 = float(p.mass.to(torch.float32).double().sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = driver.Simulation(p, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    sim.run(1, 3, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[main:incomp8M] {p.n} particles, 256^3, buckets {tuple(sim.state.shape)}: 3 substeps "
        f"in {time.perf_counter() - t0:.2f} s, launches {got}, peak device memory {peak} bytes "
        f"= {peak / 2**30:.3f} GiB  [{card}]")
    check(got["p2g3d"] == got["g2p3d"] == 3 and sum(got.values()) == 6,
          f"incomp8M: launches {got} for 3 substeps")
    launches["incomp8M_p2g3d"], launches["incomp8M_g2p3d"] = got["p2g3d"], got["g2p3d"]
    host_checks("incomp8M", sim, p.n, mass0, card)
    out = {"particles": p.n, "peak_bytes": peak}

    # p2g3d (7 channels) and g2p3d's gather mode against plain on its state.
    spec = sim.spec
    args = fast3d.p2g_args(scene)
    fields = fast3d.prepped_fields(sim.state, scene, spec)
    counts = fast3d.pencil_counts(sim.state)
    mask = sim.state.mask.view(spec.rows0, spec.rows1, spec.capacity)
    r0, r1, k3 = mask.shape
    got7 = tk3.p2g3d(fields, counts, r1, **args)
    want7 = tk3.p2g3d_plain(fields, counts, r1, args["g2"], args["dx"], args["apic"],
                            args["ext"], args["tent"])
    check(got7.shape[3] == tk3.P2G_CH, f"incomp8M: p2g3d wrote {got7.shape[3]} channels")
    err7, rel7 = scaled_errors(got7, want7, axis=3)
    del want7
    m_total = float((fields[-1].double()).sum())
    pou = abs(float(got7[:, :, :, 6].double().sum()) - m_total) / m_total
    err["incomp8M_p2g3d"] = max(err7)
    say(f"[main:incomp8M] p2g3d {got7.shape[3]} channels: max_abs_err per channel "
        f"{['%.2e' % e for e in err7]} scaled {['%.2e' % r for r in rel7]} (tol "
        f"{KERNEL_REL_TOL}); mass sum rel err {pou:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel7) <= KERNEL_REL_TOL, "incomp8M: p2g3d disagrees with its plain version")
    check(pou <= POU_REL_TOL, "incomp8M: p2g3d partition of unity")
    rerun_equal("main:incomp8M", "p2g3d", lambda: tk3.p2g3d(fields, counts, r1, **args), card)
    grid = fast3d._grid_update(tk3.fold_rows0(got7), scene)
    del got7
    dinv = float(4.0 * scene.cfg.inv_dx * scene.cfg.inv_dx)
    g2p_in = (*fields[:3], mask, counts, grid, args["dx"], dinv)
    gg, gw = tk3.g2p3d(*g2p_in), tk3.g2p3d_plain(*g2p_in)
    scale = gw.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = dinv * args["dx"] * float(grid[:, :, :3].abs().max())     # C: one term
    errg, relg = scaled_errors(gg, gw, axis=2, scale=scale)
    err["incomp8M_g2p3d"] = max(errg)
    say(f"[main:incomp8M] g2p3d gather on the {grid.shape[2]}-channel grid: max_abs_err per "
        f"channel {['%.2e' % e for e in errg]}; worst {max(relg):.2e} of its scale (tol "
        f"{KERNEL_REL_TOL})  [{card}]")
    check(max(relg) <= KERNEL_REL_TOL, "incomp8M: g2p3d disagrees with its plain version")
    del gg, gw
    live3, n_in, g3 = int(counts.sum()), len(fields), args["g2"]
    bounds["incomp8M_p2g3d"] = bound(4 * (n_in * live3 + r0 * r1 + 5 * tk3.P2G_CH * r0 * r1 * g3),
                                     live3 * 27 * tk3.P2G_CH * 2)
    bounds["incomp8M_g2p3d"] = bound(4 * (4 * live3 + r0 * r1 + grid.numel() + 15 * r0 * r1 * k3),
                                     live3 * 27 * 15 * 2)
    pairs = {"incomp8M_p2g3d": (lambda: tk3.p2g3d(fields, counts, r1, **args),
                                lambda: tk3.p2g3d_plain(fields, counts, r1, args["g2"],
                                                        args["dx"], args["apic"], args["ext"],
                                                        args["tent"])),
             "incomp8M_g2p3d": (lambda: tk3.g2p3d(*g2p_in), lambda: tk3.g2p3d_plain(*g2p_in))}
    for name, (call, plain_call) in pairs.items():
        kernel_ms[name] = cuda_ms(call, reps=10, warm=2)
        plain_ms[name] = cuda_ms(plain_call, reps=2, warm=1)
        say(f"[main:incomp8M] {name} ({n_in} planes, buckets {r0}x{r1}x{k3}, {live3} live): "
            f"kernel {kernel_ms[name]:.4f} ms (CUDA events, 10 calls), plain "
            f"{plain_ms[name]:.4f} ms (2 calls), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{card}]")
    del fields, counts, mask, grid, g2p_in, pairs
    torch.cuda.empty_cache()

    b = sim.state
    run = lambda: fast3d.run(b, scene, spec, 5)
    run()
    with CGProbe() as probe:
        out["ms_per_substep"], runs = ms_runs(run, 5)
    resid = probe.read()
    out["cg_resid"] = {"max": max(resid), "median": float(np.median(resid)),
                       "min": min(resid), "substeps": len(resid)}
    say(f"[timing:incomp8M] kernel path {out['ms_per_substep']:.4f} ms/substep (median of 3 x 5; "
        f"runs {[round(r, 4) for r in runs]}); CG exit resid {out['cg_resid']}  [{card}]")
    if profile_dir:
        out["busy_ms"] = profile_calls(
            os.path.join(profile_dir, "profile_incomp8M.txt"),
            lambda n: fast3d.run(b, scene, spec, n), 2, out["ms_per_substep"], "incomp8M", card)
    del sim, b
    torch.cuda.empty_cache()

    # 4 slab shards against one device; p2g3d_grid's raw mode on that state.
    shards = 4
    sim, ref, got = sharded_against_single("incomp8M", p, scene, dev, shards, 3, card,
                                           INCOMP_SHARD_TOL)
    check(got["p2g3d_grid"] == got["p2g3d"] == 3 and got["g2p3d"] == 6,
          f"sharded incomp8M: launches {got}")
    del ref
    torch.cuda.empty_cache()
    # The sharded run alone, counted: one p2g3d_grid and one g2p3d per substep.
    reset_counts()
    sim.step_frame(3)
    torch.cuda.synchronize()
    got = kernel_counts()
    launches["incomp8Mx4_p2g3d_grid"], launches["incomp8Mx4_g2p3d"] = (got["p2g3d_grid"],
                                                                       got["g2p3d"])
    say(f"[main:incomp8M x4] the sharded run alone, 3 substeps: launches {got}")
    check(got["p2g3d_grid"] == got["g2p3d"] == 3 and sum(got.values()) == 6,
          f"sharded incomp8M: launches {got} for 3 substeps of the sharded run alone")
    ctx = fast_domain3d.FastDomain3DCtx(sim.mesh, sim.spec.rows_per_shard0,
                                        rows1=sim.spec.local_spec.rows1)
    gspec = sim.spec.global_spec
    planes = fast3d.prepped_fields(sim.state, scene, gspec, sim.state.x0 - ctx.x0_shift(dev,
                                                                                       scene.cfg))
    counts = fast3d.pencil_counts(sim.state)
    kw = fast3d.p2g_args(scene, raw=True)
    g2, dx = kw.pop("g2"), kw.pop("dx")
    name = "incomp8Mx4_p2g3d_grid"
    raw = tk3.p2g3d_grid(planes, counts, gspec.rows1, g2, dx, raw=True, shards=shards, **kw)
    want = tk3.p2g3d_raw_plain(planes, counts, g2, dx, shards=shards, **kw)
    err_r, rel_r = scaled_errors(raw, want, axis=3)
    del want
    err[name] = max(err_r)
    say(f"[main:incomp8M x4] p2g3d_grid raw on the sharded state: max_abs_err per channel "
        f"{['%.2e' % e for e in err_r]} scaled {['%.2e' % r for r in rel_r]} (tol "
        f"{KERNEL_REL_TOL})  [{card}]")
    check(max(rel_r) <= KERNEL_REL_TOL, "incomp8M x4: p2g3d_grid raw disagrees with plain")
    kernel_ms[name] = cuda_ms(lambda: tk3.p2g3d_grid(planes, counts, gspec.rows1, g2, dx,
                                                     raw=True, shards=shards, **kw), reps=5)
    plain_ms[name] = cuda_ms(lambda: tk3.p2g3d_raw_plain(planes, counts, g2, dx, shards=shards,
                                                         **kw), reps=2, warm=1)
    live = int(counts.sum())
    bounds[name] = bound(4 * (len(planes) * live + counts.numel() + raw.numel()),
                         live * 27 * raw.shape[3] * 2)
    say(f"[main:incomp8M x4] p2g3d_grid raw {kernel_ms[name]:.4f} ms (CUDA events, 5 calls), "
        f"plain {plain_ms[name]:.4f} ms (2 calls), bound {bounds[name][0]:.4f} ms "
        f"({bounds[name][1]})  [{card}]")
    del raw, planes, counts
    torch.cuda.empty_cache()
    compare_g2p3d_sharded("incomp8M", fast3d.prepped_fields(
        sim.state, scene, gspec, sim.state.x0 - ctx.x0_shift(dev, scene.cfg)),
        fast3d._shaped(sim.state.mask, gspec), fast3d.pencil_counts(sim.state), None, scene,
        gspec, ctx, err, kernel_ms, plain_ms, bounds, card, key="incomp8Mx4_g2p3d")
    del sim, p
    torch.cuda.empty_cache()

    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    out["vs_general_slab1M"] = general_vs_fast("incomp slab1M", p1, incompressible(scene1), dev,
                                               card, n_time=2)
    return out


def drop_scene(num_grids, sigma, dt, particles, dtype=np.float32):
    """The zero-gravity 2:1 drop of tests/test_surface_tension.py:19-52:
    0.22 x 0.11 of the box, centred, `particles` across, sigma, slip walls."""
    from mpm_flip98a_tpu_torch.config import MPMConfig, Physics
    from mpm_flip98a_tpu_torch.models import materials as mat
    from mpm_flip98a_tpu_torch.models.stabilized import Scene, WallBC
    from mpm_flip98a_tpu_torch.state import Particles

    cfg = MPMConfig(dtype=np.dtype(dtype).name, num_grids=num_grids, dt=dt,
                    surface_tension=sigma)
    physics = Physics(gravity=0.0)
    l = cfg.domain_length
    size = (0.22 * l, 0.11 * l)
    axes = [(np.arange(n) + 0.5) * (s / n) + 0.5 * (l - s) for n, s in zip(particles, size)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2).astype(dtype)
    p = Particles.init(torch.from_numpy(x), volume0=size[0] * size[1] / len(x),
                       density=physics.particle_density)
    return p, Scene(cfg=cfg, physics=physics,
                    params=mat.MaterialParams(bulk_modulus=physics.bulk_modulus,
                                              dynamic_viscosity=physics.dynamic_viscosity),
                    wall=WallBC("slip"), mass_floor=1e-8 * float(p.mass.min()))


def anisotropy(x):
    c = x - x.mean(axis=0)
    ixx, iyy = (c[:, 0] ** 2).mean(), (c[:, 1] ** 2).mean()
    return max(ixx, iyy) / max(min(ixx, iyy), 1e-30)


def csf_phases(dev, card):
    """csf513 (the drop on 513^2: fast against general after one substep,
    ms per substep) and the physics checks at 41^2 on both paths: the drop
    rounds within 1500 substeps (moment ratio < 0.75 of its start,
    test_surface_tension.py:55-72) and sigma = 0 stays static to 1e-6 over
    300 (:75-80)."""
    from mpm_flip98a_tpu_torch.models import fast2d, stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    from mpm_flip98a_tpu_torch.config import MPMConfig

    out = {}
    dx41, dx513 = (MPMConfig(num_grids=g).dx for g in (DROP41["num_grids"], CSF513["num_grids"]))
    across = round(DROP41["particles"][0] * dx41 / dx513)
    p, scene = drop_scene(CSF513["num_grids"], 5.0, CSF513["dt"], (across, across // 2))
    out["csf513"] = general_vs_fast("csf513", p, scene, dev, card, n_time=20)
    out["csf513"]["particles"] = p.n
    for sigma, n_sub in ((5.0, 1500), (0.0, 300)):
        p, scene = drop_scene(DROP41["num_grids"], sigma, DROP41["dt"], DROP41["particles"])
        x0 = p.x.double().numpy()
        for path in ("general", "fast"):
            t0 = time.perf_counter()
            if path == "general":
                x = stabilized.run(to_device(p, dev), scene, n_sub).x.double().cpu().numpy()
            else:
                spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
                b = fast2d.run(fast2d.from_particles(p, scene.cfg, spec, dev), scene, spec, n_sub)
                h = fast2d.to_host(b)
                x = np.stack([h["x0"], h["x1"]], -1).astype(np.float64)
                check(int(b.overflow) == 0, f"drop41 {path}: overflow")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(bool(np.isfinite(x).all()) and x.shape == x0.shape, f"drop41 {path}: state")
            key = f"drop41_sigma{sigma:g}_{path}"
            if sigma > 0:
                a0, a1 = anisotropy(x0), anisotropy(x)
                out[key] = {"moment_ratio_start": float(a0), "moment_ratio_end": float(a1)}
                say(f"[main:csf drop41 {path}] sigma {sigma}, {n_sub} substeps in {secs:.2f} s: "
                    f"moment ratio {float(a0)!r} -> {float(a1)!r} (bound < 0.75 x start)  "
                    f"[{card}]")
                check(a0 > 3.5 and a1 < 0.75 * a0, f"drop41 {path}: the drop did not round")
            else:
                moved = float(np.abs(x - x0).max())
                out[key] = {"max_displacement": moved}
                say(f"[main:csf drop41 {path}] sigma 0, {n_sub} substeps in {secs:.2f} s: max "
                    f"displacement {moved!r} (bound 1e-6)  [{card}]")
                check(moved <= 1e-6, f"drop41 {path}: the sigma = 0 drop moved {moved}")
    return out


def collider_incomp(dev, card):
    """dam2d_obstacle and dam3d_obstacle with the projection: one substep
    fast against general (slot for slot), then 200 (2D) or 100 (3D)
    substeps of each path: finite, no particle deeper than 1.5 dx inside
    the collider, ensemble mean and std within 5e-4.  In both scenes the
    front does not reach the collider in those substeps, so one more
    substep is compared with the collider moved against the column's edge
    (`TOUCHING`), where its solid nodes border fluid nodes in the CG."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import scenes

    out = {}
    for scenario, n_sub in (("dam2d_obstacle", 200), ("dam3d_obstacle", 100)):
        p, scene = driver.SCENARIOS[scenario]()
        scene = incompressible(scene)
        entry = {"vs_general": general_vs_fast(f"incomp {scenario}", p, scene, dev, card,
                                               n_time=3)}
        build = scenes.dam_break_obstacle_2d if scene.cfg.dim == 2 else scenes.dam_break_obstacle_3d
        p_t, scene_t = build(center_frac=TOUCHING[scenario])
        entry["touching_vs_general"] = general_vs_fast(
            f"incomp {scenario} touching", p_t, incompressible(scene_t), dev, card, n_time=1)
        del p_t
        sims = {}
        for path in ("general", "fast"):
            sim = driver.Simulation(p, scene, path=path, out_dir=tempfile.gettempdir(),
                                    device=dev)
            reset_counts()
            t0 = time.perf_counter()
            sim.run(1, n_sub, gif=False, verbose=False, write_frames=False)
            torch.cuda.synchronize()
            got = kernel_counts()
            depth = penetration(sim)
            say(f"[main:incomp colliders {scenario} {path}] {n_sub} substeps in "
                f"{time.perf_counter() - t0:.2f} s, launches {got}, deepest particle inside "
                f"the collider {depth:.3f} dx (bound 1.5)  [{card}]")
            if path == "general":
                general_host_checks(f"incomp {scenario} general", sim, p.n, float(p.mass.sum()),
                                    card)
            else:
                check(sum(got.values()) == 2 * n_sub, f"{scenario}: launches {got}")
                host_checks(f"incomp {scenario} fast", sim, p.n,
                            float(p.mass.to(torch.float32).double().sum()), card)
            check(depth < 1.5, f"incomp {scenario} {path}: a particle {depth:.3f} dx inside")
            entry[f"{path}_depth_dx"] = depth
            sims[path] = sim
        (m, s), (mr, sr) = ensemble(sims["fast"]), ensemble(sims["general"])
        entry["mean_diff"], entry["std_diff"] = float(np.abs(m - mr).max()), float(
            np.abs(s - sr).max())
        say(f"[main:incomp colliders {scenario}] after {n_sub} substeps fast against general: "
            f"ensemble mean |diff| {entry['mean_diff']:.3e}, std |diff| {entry['std_diff']:.3e} "
            f"(tol 5e-4)  [{card}]")
        check(entry["mean_diff"] <= 5e-4 and entry["std_diff"] <= 5e-4,
              f"incomp {scenario}: fast left the general path's ensemble")
        out[scenario] = entry
        del sims
    return out


def incompressible_phases(dev, card, io_ok, profile_dir, err, kernel_ms, plain_ms, bounds,
                          launches):
    """Phase 36, main:incompressible; fills INCOMP and prints its line."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    t0 = time.perf_counter()
    for path, devices in (("fast", 1), ("general", 1), ("fast", 4)):
        INCOMP[f"cli_{path}_x{devices}"] = incomp_cli(dev, card, io_ok, path, devices)
    say(f"[timing] incompressible CLIs done in {time.perf_counter() - t0:.1f} s")
    # Card against CPU: the general path (float64) after 200 substeps.
    p, scene = driver.SCENARIOS["dam2d_incompressible"]()
    state = stabilized.run(to_device(p, dev), scene, 200)
    every = {f.name: GENERAL_TOL[torch.float64] for f in dataclasses.fields(state)}
    term = 4.0 * float(state.v.abs().max()) / scene.cfg.dx     # C's terms: as in main:plastic
    INCOMP["vs_cpu_200"] = card_vs_cpu("dam2d_incompressible after 200", state, scene, every,
                                       card, {"C": term, "div_v": term})
    del state
    INCOMP["incomp1M"] = incomp1m(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds,
                                  launches)
    say(f"[timing] incomp1M done in {time.perf_counter() - t0:.1f} s")
    INCOMP["incomp8M"] = incomp8m(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds,
                                  launches)
    say(f"[timing] incomp8M done in {time.perf_counter() - t0:.1f} s")
    INCOMP["csf"] = csf_phases(dev, card)
    say(f"[timing] csf done in {time.perf_counter() - t0:.1f} s")
    INCOMP["colliders"] = collider_incomp(dev, card)
    say(f"[timing] incompressible phases done in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"incompressible": INCOMP}))


# ---------------------------------------------------------------------------
# The general path's fixed-order scatter, checkpoints, the two-axis mesh and
# p2g3d's halo1 mode
# ---------------------------------------------------------------------------

SCATTER = {}                 # the kernels line's "scatter" entry
# The general path in float32, card against CPU after 200 substeps at 37^2:
# v and C within this share of their scale (1e-4 while the scatter added in
# atomic order; with the fixed-order scatter the card read v 0.0 and C
# 4.4e-7 on an H100 80GB HBM3 at 700 W; the rest of CARRIED's bounds as
# they were).
CARRIED_FIXED = dict(CARRIED, v=1e-6, C=1e-6)


def scatter_calls(call):
    """Every scatter that `call()` makes, in order: ("stencil", values
    (N, S, c), base, offsets, grid shape) of the node transfers and
    ("one_tap", values (M, c), flat, nodes) of the F-bar cell sums."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    seen, real_s, real_a = [], scatter.stencil_add, scatter.scatter_add

    def stencil(values, base, offsets, grid_shape, plan=None):
        seen.append(("stencil", values.clone(), base.clone(), offsets, tuple(grid_shape)))
        return real_s(values, base, offsets, grid_shape, plan)

    def one_tap(values, flat, nodes, plan=None):
        seen.append(("one_tap", values.clone(), flat.clone(), nodes))
        return real_a(values, flat, nodes, plan)

    scatter.stencil_add, scatter.scatter_add = stencil, one_tap
    try:
        call()
    finally:
        scatter.stencil_add, scatter.scatter_add = real_s, real_a
    return seen


def _scatter_fns(call):
    """(kernel, plain on the same device, plain on the CPU) of one
    captured scatter."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    if call[0] == "stencil":
        _, values, base, offsets, shape = call
        return (lambda: scatter.stencil_add(values, base, offsets, shape),
                lambda: scatter.stencil_add_plain(values, base, offsets, shape),
                lambda: scatter.stencil_add_plain(values.cpu(), base.cpu(), offsets, shape))
    _, values, flat, nodes = call
    return (lambda: scatter.scatter_add(values, flat, nodes),
            lambda: scatter.scatter_add_plain(values, flat, nodes),
            lambda: scatter.scatter_add_plain(values.cpu(), flat.cpu(), nodes))


def general_reruns(tag, p, scene, dev, n_sub, card):
    """Two n_sub-substep general runs from the same particles on the card:
    every field bitwise equal.  Returns (equal, scatter launches of one
    run)."""
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.ops.cuda import scatter
    from mpm_flip98a_tpu_torch.state import to_device

    start = to_device(p, dev)
    scatter.reset_launches()
    reset_counts()
    t0 = time.perf_counter()
    a = stabilized.run(start, scene, n_sub)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_launch = scatter.LAUNCHES["scatter"]
    n_keys = scatter.LAUNCHES["scatter_keys"]
    b = stabilized.run(start, scene, n_sub)
    differ = [f.name for f in dataclasses.fields(a) if not torch.equal(getattr(a, f.name),
                                                                        getattr(b, f.name))]
    say(f"[main:general_determinism {tag}] {p.n} particles, {a.x.dtype}: two {n_sub}-substep "
        f"general runs on the card, fields not bitwise equal {differ}; {n_launch} scatter "
        f"and {n_keys} key-kernel launches a run, transfer kernels {kernel_counts()}; "
        f"{1e3 * secs / n_sub:.4f} ms/substep  [{card}]")
    check(not differ, f"{tag}: two general runs on the card differ in {differ}")
    check(n_launch >= n_sub and n_keys >= n_sub and not any(kernel_counts().values()),
          f"{tag}: the general path did not go through the scatter kernels alone")
    return not differ, n_launch, n_keys


def scatter_against(tag, calls, card, timed=False):
    """Each captured scatter through the kernel against the CPU's
    `index_add_` on the same rows (bitwise) and the plain version on the
    card; with `timed`, the largest stencil call's times (`time_stencil`)."""
    equal, worst = True, 0.0
    for call in calls:
        kernel, plain, cpu = _scatter_fns(call)
        got = kernel()
        equal = equal and torch.equal(got.cpu(), cpu())
        worst = max(worst, float((got - plain()).abs().max()))
    rerun = True
    for call in calls:
        kernel = _scatter_fns(call)[0]
        rerun = rerun and torch.equal(kernel(), kernel())
    say(f"[main:general_determinism {tag}] {len(calls)} scatters of one substep "
        f"({[(c[0], tuple(c[1].shape)) for c in calls]}): kernel bitwise equal to the CPU's "
        f"index_add_ {equal}, reruns bitwise equal {rerun}, max |kernel - index_add_ on the "
        f"card| {worst:.3e}  [{card}]")
    check(equal, f"{tag}: the scatter kernel differs from the CPU's index_add_")
    check(rerun, f"{tag}: scatter reruns differ")
    SCATTER["equal_to_cpu"] = SCATTER.get("equal_to_cpu", True) and equal
    SCATTER["rerun_bitwise_equal"] = SCATTER.get("rerun_bitwise_equal", True) and rerun
    SCATTER["max_abs_err"] = max(SCATTER.get("max_abs_err", 0.0), worst)
    if timed:
        time_stencil(tag, max((c for c in calls if c[0] == "stencil"),
                              key=lambda c: c[1].numel()), card)


def time_stencil(tag, call, card):
    """The stencil scatter's kernel on a given plan, the plan (whole, and
    its stable sort alone), `index_add_` alone over the clipped rows, the
    plain version, and the bound: the rows read (the taps in bounds), the
    order, the starts and the sums, each moved once, one add a row
    channel.  Back to back by CUDA events (host time between launches
    shows where it exceeds the device's), and on the device alone
    (`device_ms`).  Also the plan's key kernel against its plain version."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    _, values, base, offsets, shape = call
    n, taps, c = values.shape
    nodes = int(np.prod(shape))
    plan = scatter.stencil_plan(base, shape)
    keys, cells = scatter.stencil_keys(base, shape)
    keys_equal = torch.equal(keys, scatter.stencil_keys_plain(base, shape)[0])
    check(keys_equal, f"{tag}: the plan's key kernel differs from its plain version")
    flat, in_bounds = scatter.stencil_flat(base, offsets, shape)
    rows = torch.where(in_bounds[..., None], values, 0.0).reshape(-1, c)
    flat = flat.reshape(-1)
    zero = torch.zeros((nodes, c), dtype=values.dtype, device=values.device)
    kernel = lambda: scatter.stencil_add(values, base, offsets, shape, plan)
    whole = lambda: scatter.stencil_plan(base, shape)
    library = lambda: zero.index_add_(0, flat, rows)
    t = {
        "ms": cuda_ms(kernel),
        "plan_ms": cuda_ms(whole),
        "sort_ms": cuda_ms(lambda: torch.sort(keys, stable=True)),
        "plain_ms": cuda_ms(lambda: scatter.stencil_add_plain(values, base, offsets, shape)),
        "library_ms": cuda_ms(library),
        "device_ms": device_ms(kernel),
        "plan_device_ms": device_ms(whole),
        "library_device_ms": device_ms(library),
        "keys_ms": cuda_ms(lambda: scatter.stencil_keys(base, shape)),
        "keys_plain_ms": cuda_ms(lambda: scatter.stencil_keys_plain(base, shape)),
        "keys_equal": keys_equal,
    }
    read = int(in_bounds.sum())
    longest = int((plan.starts[1:] - plan.starts[:-1]).max())
    t["bound_ms"], t["bound_by"] = bound(
        values.element_size() * (read + nodes) * c + 4 * (int(plan.starts[-1]) + cells + 1),
        read * c)
    t["keys_bound_ms"], t["keys_bound_by"] = bound(base.element_size() * base.numel() + 4 * n, 0)
    t["kernel_plus_plan_ms"] = t["ms"] + t["plan_ms"]
    t["kernel_plus_plan_device_ms"] = t["device_ms"] + t["plan_device_ms"]
    say(f"[timing:scatter {tag}] {n} particles x {taps} taps x {c} channels ({values.dtype}) "
        f"into {nodes} nodes, {read} rows read, longest run {longest}: kernel {t['ms']:.4f} ms "
        f"+ the plan (key kernel, int32 stable sort of {n} keys, starts by searchsorted) "
        f"{t['plan_ms']:.4f} ms (its sort alone {t['sort_ms']:.4f} ms) = "
        f"{t['kernel_plus_plan_ms']:.4f} ms against index_add_ alone over the {n * taps} "
        f"clipped rows {t['library_ms']:.4f} ms; on the device alone {t['device_ms']:.4f} + "
        f"{t['plan_device_ms']:.4f} = {t['kernel_plus_plan_device_ms']:.4f} ms against "
        f"{t['library_device_ms']:.4f}; plain (stencil_add_plain: flat index, mask, index_add_) "
        f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}); the key "
        f"kernel {t['keys_ms']:.4f} ms (plain {t['keys_plain_ms']:.4f}, bound "
        f"{t['keys_bound_ms']:.4f}), equal to its plain version {keys_equal} (CUDA events, 20 "
        f"calls after 3)  [{card}]")
    SCATTER.update(t if tag == "bench1M" else {f"{tag}_{k}": v for k, v in t.items()})


def dense_node(p, scene, dev, card):
    """Bench 1M with 20,000 of its particles moved to one point (one key
    cell whose 9 nodes each read all of them): every scatter of a substep
    bitwise the CPU's index_add_, reruns equal, and the momentum scatter's
    time beside index_add_'s."""
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    x = p.x.clone()
    x[np.random.default_rng(0).choice(p.n, 20_000, replace=False)] = x[p.n // 2].clone()
    state = to_device(dataclasses.replace(p, x=x), dev)
    scatter_against("dense", scatter_calls(lambda: stabilized.substep(state, scene)), card,
                    timed=True)


def general_determinism(dev, card):
    """Phase 37, main:general_determinism: bitwise general reruns on the
    card (the 37^2 float32 scene of tests/test_determinism.py, bench 1M),
    the scatter kernel bitwise the CPU's index_add_ (the reference scene's,
    bench 1M's, slab 1M's and the dense node's substep inputs), card
    against CPU after 200 float32 substeps at 37^2, and the scatter's time
    against index_add_ at bench 1M, slab 1M and the dense node."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import scenes, stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    cfg37 = MPMConfig(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32,
                      dtype="float32")
    p37, scene37 = scenes.dam_break_2d(cfg37, dtype=np.float32)
    general_reruns("37^2", p37, scene37, dev, 100, card)
    p_b, scene_b = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC),
                                       dtype=np.float32)
    _, SCATTER["launches"], SCATTER["keys_launches"] = general_reruns("bench1M", p_b, scene_b,
                                                                      dev, 100, card)
    p_ref, scene_ref = driver.SCENARIOS["dam2d"]()
    ref_state = stabilized.run(to_device(p_ref, dev), scene_ref, 100)
    scatter_against("reference", scatter_calls(lambda: stabilized.substep(ref_state,
                                                                          scene_ref)), card)
    b_state = to_device(p_b, dev)
    scatter_against("bench1M", scatter_calls(lambda: stabilized.substep(b_state, scene_b)),
                    card, timed=True)
    del b_state, ref_state
    dense_node(p_b, scene_b, dev, card)
    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    s1 = to_device(p1, dev)
    scatter_against("slab1M", scatter_calls(lambda: stabilized.substep(s1, scene1)), card,
                    timed=True)
    del s1, p1
    torch.cuda.empty_cache()
    # main:general_vs_cpu's float32 cell, with the scatter in the CPU's order.
    p37s, scene37s = scenes.dam_break_2d(MPMConfig(**STAB37, transfer=TransferKind.PIC),
                                         dtype=np.float32)
    s37 = stabilized.run(to_device(p37s, dev), scene37s, 200)
    got = card_vs_cpu("stab1M set at 37^2 after 200, fixed-order scatter", s37, scene37s,
                      CARRIED_FIXED, card)
    check(got["rerun_bitwise_equal"], "general_vs_cpu: two card substeps differ")
    SCATTER["vs_cpu_37_v"], SCATTER["vs_cpu_37_C"] = got["cpu_err"]["v"], got["cpu_err"]["C"]


def resume_gate(tag, p, scene, dev, n_sub, path_kw, ck_name, card):
    """2 frames of n_sub substeps uninterrupted against 1 frame, a
    checkpoint, a fresh Simulation restoring it and 1 more frame: every
    field bitwise equal (every P2G kernel sums in a fixed order).  Returns
    the write and read seconds and the checkpoint's bytes."""
    from mpm_flip98a_tpu_torch import driver

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        make = lambda: driver.Simulation(p, scene, out_dir=tmp, device=dev, **path_kw)
        whole = make()
        whole.run(2, n_sub, gif=False, verbose=False, write_frames=False)
        first = make()
        first.run(1, n_sub, gif=False, verbose=False, write_frames=False)
        ck = os.path.join(tmp, ck_name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save_checkpoint(ck)
        t_write = time.perf_counter() - t0
        nbytes = (os.path.getsize(ck) if ck.endswith(".npz") else
                  sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck)))
        del first
        resumed = make()
        t0 = time.perf_counter()
        resumed.restore_checkpoint(ck)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        resumed.run(1, n_sub, gif=False, verbose=False, write_frames=False)
        diff = {f.name: float((getattr(resumed.state, f.name).double()
                               - getattr(whole.state, f.name).double()).abs().max())
                for f in dataclasses.fields(whole.state)}
        equal = all(torch.equal(getattr(resumed.state, f.name), getattr(whole.state, f.name))
                    for f in dataclasses.fields(whole.state))
        line = (f"[main:checkpoint {tag}] {p.n} particles, 2 x {n_sub} substeps: resumed "
                f"(frame {resumed.frame_count}, t {resumed.total_time:.6g} s) against "
                f"uninterrupted: bitwise equal {equal}, max |diff| {max(diff.values()):.3e}; "
                f"checkpoint {ck_name} {nbytes} bytes, write {t_write:.3f} s, read "
                f"{t_read:.3f} s")
        check(resumed.frame_count == 2, f"{tag}: resumed frame count {resumed.frame_count}")
        say(f"{line}  [{card}]")
        check(equal, f"{tag}: the resumed run differs from the uninterrupted one: {diff}")
        return {"equal": equal, "max_abs_diff": max(diff.values()), "write_s": t_write,
                "read_s": t_read, "bytes": nbytes}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_phase(dev, card):
    """Phase 38, main:checkpoint: resumed against uninterrupted runs on
    the bench 1M fast path, the reference scene's general path (float64),
    bench 1M in 4 shards with a directory checkpoint and slab 1M / 128^3
    on the fused and the relative-floor routes, all bitwise."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import scenes

    out = {}
    p_b, scene_b = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC),
                                       dtype=np.float32)
    out["bench1M"] = resume_gate("bench1M fast", p_b, scene_b, dev, 50, dict(path="fast"),
                                 "bench.npz", card)
    out["bench1Mx4"] = resume_gate("bench1M x 4 shards", p_b, scene_b, dev, 50,
                                   dict(path="fast", devices=4), "bench_dir", card)
    p_ref, scene_ref = driver.SCENARIOS["dam2d"]()
    out["reference_general"] = resume_gate("reference general float64", p_ref, scene_ref, dev,
                                           200, dict(path="general"), "general.npz", card)
    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    out["slab1M"] = resume_gate("slab1M fast", p1, scene1, dev, 10, dict(path="fast"),
                                "slab.npz", card)
    # The 3D fast path through the fixed-order `p2g3d` (the stabilized set
    # with the relative floor: relfloor3d's route), bitwise, with the
    # F-bar and mixing state (jbar_s, p_s, div_s) in the checkpoint.
    rel = dataclasses.replace(scene1, cfg=dataclasses.replace(scene1.cfg, **STAB),
                              mass_floor=0.0)
    out["relfloor1M"] = resume_gate("slab1M relfloor3d route", p1, rel, dev, 10,
                                    dict(path="fast"), "relfloor.npz", card)
    torch.cuda.empty_cache()
    return out


def windows_against_plain(tag, sim, scene, p2g_key, g2p_key, err, kernel_ms, plain_ms, bounds,
                          card, plan_key=None):
    """Raw `p2g3d_grid` and `g2p3d` on a sharded Simulation's windows (the
    one-axis slabs or the two-axis (L0, L1) windows, positions local to
    each) against their plain versions: per channel, the raw mass sum,
    times and bounds under `p2g_key` and `g2p_key` (None:
    `compare_g2p3d_sharded`'s own), `p2g3d_grid`'s plan under `plan_key`.
    Returns halo_sync's ms on the raw sums."""
    from mpm_flip98a_tpu_torch.config import TransferKind
    from mpm_flip98a_tpu_torch.models import fast3d
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d

    ctx = fast_domain3d.context(sim.spec, sim.mesh)
    gspec, cfg, b = sim.spec.global_spec, scene.cfg, sim.state
    x0s, x1s = fast3d._shifts(b, cfg, ctx)
    x0k, x1k = b.x0 - x0s, None if x1s is None else b.x1 - x1s
    mask, state = fast3d._shaped(b.mask, gspec), None
    if fast3d.uses_fused(scene):
        planes, counts, _, state = fast3d.transfer_inputs(b, gspec, cfg, x0k, x1k)
        m_plane = planes[16] * (torch.arange(gspec.capacity, device=counts.device)
                                < counts.view(*planes[0].shape[:2], 1))
    else:
        planes, counts = fast3d.prepped_fields(b, scene, gspec, x0k, x1k), fast3d.pencil_counts(b)
        m_plane = planes[tk3.n_prepped(cfg.transfer == TransferKind.APIC, False) - 1]
    del x0k, x1k
    kw = fast3d.p2g_args(scene, raw=True)
    g2, dx = kw.pop("g2"), kw.pop("dx")
    n, r1 = sim.spec.n_shards, gspec.rows1
    call = lambda: tk3.p2g3d_grid(planes, counts, r1, g2, dx, raw=True, shards=n, **kw)
    got = call()
    want = tk3.p2g3d_raw_plain(planes, counts, g2, dx, shards=n, **kw)
    err_r, rel_r = scaled_errors(got, want, axis=3)
    del want
    m_total = float(m_plane.double().sum())
    pou = abs(float(got[:, :, :, 6].double().sum()) - m_total) / m_total
    del m_plane
    err[p2g_key] = max(err_r)
    say(f"[kernels:sharded3d {tag}] p2g3d_grid raw, {n} shards, shape {tuple(got.shape)}: "
        f"max_abs_err per channel {['%.2e' % e for e in err_r]} scaled "
        f"{['%.2e' % r for r in rel_r]} (tol {KERNEL_REL_TOL}); mass sum rel err {pou:.3e} "
        f"(tol {POU_REL_TOL})  [{card}]")
    check(max(rel_r) <= KERNEL_REL_TOL, f"{tag}: p2g3d_grid raw disagrees with plain")
    check(pou <= POU_REL_TOL, f"{tag}: p2g3d_grid raw partition of unity")
    two_axis = sim.spec.n_shards1 > 1
    rerun_equal(f"kernels:sharded3d {tag}",
                "p2g3d_grid_raw_2x2" if two_axis else f"p2g3d_grid_raw_{n}_shards", call, card)
    kernel_ms[p2g_key] = cuda_ms(call, reps=10)
    plain_ms[p2g_key] = cuda_ms(lambda: tk3.p2g3d_raw_plain(planes, counts, g2, dx, shards=n,
                                                            **kw), reps=2, warm=1)
    live = int(counts.sum())
    bounds[p2g_key] = bound(4 * (len(planes) * live + counts.numel() + got.numel()),
                            live * 27 * got.shape[3] * 2)
    halo = got.clone()
    halo_ms = cuda_ms(lambda: ctx.halo_sync(halo), reps=10)
    say(f"[kernels:sharded3d {tag}] p2g3d_grid raw {kernel_ms[p2g_key]:.4f} ms (CUDA events, "
        f"10 calls, one launch each), plain {plain_ms[p2g_key]:.4f} ms (2 calls), bound "
        f"{bounds[p2g_key][0]:.4f} ms ({bounds[p2g_key][1]}); halo_sync {halo_ms:.4f} ms  "
        f"[{card}]")
    if plan_key:
        plan_line(f"kernels:sharded3d {tag}", plan_key, got.shape[3], g2, planes[0].shape[0], r1,
                  card, n, apic=bool(kw["apic"]))
    del got, halo
    compare_g2p3d_sharded(tag, planes, mask, counts, state, scene, gspec, ctx, err, kernel_ms,
                          plain_ms, bounds, card, key=g2p_key)
    return halo_ms


def time_meshes(tag, sims, n_sub, reps, card):
    """ms per substep of each Simulation in `sims` (name -> sim),
    interleaved, median of `reps`; returns the medians."""
    runs = {k: [] for k in sims}
    for s in sims.values():
        s.step_frame(2)
    for _ in range(reps):
        for k, s in sims.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.step_frame(n_sub)
            torch.cuda.synchronize()
            runs[k].append(1e3 * (time.perf_counter() - t0) / n_sub)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    say(f"[timing:two_axis {tag}] ms/substep, median of {reps} x {n_sub}, interleaved: "
        + "; ".join(f"{k} {med[k]:.4f} (runs {[round(t, 4) for t in runs[k]]})" for k in sims)
        + f"  [{card}]")
    return med, runs


def two_axis_phase(dev, card, err, kernel_ms, plain_ms, bounds, launches):
    """Phase 39, main:two_axis: the dam3d CLI on 2 x 2 windows with a
    checkpoint and a resume; slab 8M, stab3d-8M and incomp8M on 2 x 2
    against one device (with an axis-1 halo fault in the CG); the kernels
    on the windows against plain; launches of the sharded run alone; ms per
    substep of 2 x 2, 4 x 1 and one device."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import scenes

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_2x2_")
    try:
        base = ["--scenario", "dam3d", "--path", "fast", "--devices", "2x2", "--substeps", "100",
                "--no-gif", "--device", str(dev)]
        ck = os.path.join(tmp, "ck")
        reset_counts()
        t0 = time.perf_counter()
        sim = driver.main(base + ["--frames", "2", "--out", tmp, "--checkpoint", ck])
        torch.cuda.synchronize()
        got = kernel_counts()
        p3, _ = driver.SCENARIOS["dam3d"]()
        say(f"[main:two_axis dam3d] CLI --devices 2x2, 2 frames x 100 substeps in "
            f"{time.perf_counter() - t0:.2f} s: launches {got}, shards {sim.devices}, "
            f"checkpoint {sorted(os.listdir(ck))}  [{card}]")
        check(got["p2g3d_grid"] == got["g2p3d"] == 200 and got["p2g3d"] == 0,
              f"dam3d 2x2: launches {got}")
        launches["p2g3d_grid win2 cli"] = launches["g2p3d win2 cli"] = got["p2g3d_grid"]
        host_checks("two_axis dam3d", sim, p3.n, float(p3.mass.to(torch.float32).double().sum()),
                    card)
        resumed = driver.main(base + ["--frames", "1", "--out", os.path.join(tmp, "r"),
                                      "--resume", ck])
        say(f"[main:two_axis dam3d] --resume: frame {resumed.frame_count}, t "
            f"{resumed.total_time:.6g} s, {resumed.stats.substeps} substeps  [{card}]")
        check(resumed.frame_count == 3, "dam3d 2x2: the resumed run's frame count")
        host_checks("two_axis dam3d resumed", resumed, p3.n,
                    float(p3.mass.to(torch.float32).double().sum()), card)
        del sim, resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    scene_stab = dataclasses.replace(scene8, cfg=dataclasses.replace(scene8.cfg, **STAB))
    scene_inc = incompressible(scene8)
    for tag, scene, n_sub, tol in (("slab8M", scene8, 20, KERNEL_REL_TOL),
                                   ("stab3d-8M", scene_stab, 2, KERNEL_REL_TOL),
                                   ("incomp8M", scene_inc, 2, INCOMP_SHARD_TOL)):
        sim, ref, _ = sharded_against_single(f"{tag} 2x2", p8, scene, dev, (2, 2), n_sub, card,
                                             vc_tol=tol)
        reset_counts()
        sim.step_frame(3)
        torch.cuda.synchronize()
        got = kernel_counts()
        say(f"[main:two_axis {tag}] the 2x2 run alone, 3 substeps: launches {got}  [{card}]")
        check(got["p2g3d_grid"] == got["g2p3d"] == 3 and got["p2g3d"] == 0,
              f"{tag} 2x2: launches {got}")
        launches[f"p2g3d_grid win2 {tag}"] = launches[f"g2p3d win2 {tag}"] = 3
        if tag == "incomp8M":
            del sim, ref
            torch.cuda.empty_cache()
            out["incomp8M_axis1_fault"] = halo_fault("incomp8M 2x2", p8, scene, dev, (2, 2),
                                                     card, axis=1)
        elif tag == "slab8M":
            out["halo_ms"] = windows_against_plain(
                f"{tag} 2x2", sim, scene, f"p2g3d_grid_win2_{tag}", f"g2p3d_win2_{tag}", err,
                kernel_ms, plain_ms, bounds, card)
            four = driver.Simulation(p8, scene, path="fast", out_dir=tempfile.gettempdir(),
                                     device=dev, devices=4)
            out["ms"], out["runs"] = time_meshes(
                tag, {"2x2": sim, "4x1": four, "one device": ref}, 10, 3, card)
            del sim, ref, four
        else:
            windows_against_plain(f"{tag} 2x2", sim, scene, f"p2g3d_grid_win2_{tag}",
                                  f"g2p3d_win2_{tag}", err, kernel_ms, plain_ms, bounds, card)
            del sim, ref
        torch.cuda.empty_cache()
    out["stab2x2_vs_cpu"] = stab2x2_drift(dev, card)
    return out


def stab2x2_drift(dev, card, n_sub=10):
    """The stabilized set on 2 x 2 windows at 32^3 (tests/test_torch_cuda.py's
    two-axis case), n_sub substeps on the card against the CPU: the largest
    |v| difference over v's max, a reading (F-bar's nodal Jbar is 1 less a
    few ulps, so the sums' order moves the pressure by parts in 1e5 a
    substep), not a gate."""
    from mpm_flip98a_tpu_torch.config import TransferKind
    from mpm_flip98a_tpu_torch.models import scenes
    from mpm_flip98a_tpu_torch.parallel import SlabMesh
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

    p, scene = scenes.dam_break_3d(num_grids=32, particles_per_axis=(16, 16, 20), dt=2e-5,
                                   flip_blend=0.98, transfer=TransferKind.PIC, **STAB)
    spec = fd3.FastDomain3DSpec.for_particles(scene.cfg, (2, 2), p)
    runs = {}
    for where in (dev, torch.device("cpu")):
        mesh = SlabMesh(2, where, 2)
        b = fd3.distribute(p, scene.cfg, spec, mesh)
        runs[where.type] = fd3.make_run(scene, spec, mesh)(b, n_sub)
    stack = lambda b: torch.stack([getattr(b, f"v{a}").cpu() for a in range(3)]).double()
    v, vw = stack(runs[dev.type]), stack(runs["cpu"])
    rel = float((v - vw).abs().max() / vw.abs().max())
    say(f"[main:two_axis stab2x2] the stabilized set on 2 x 2 windows at 32^3, {n_sub} "
        f"substeps, card against CPU: max |v - v_cpu| {rel:.3e} of v's max (a reading)  "
        f"[{card}]")
    return rel


def halo1_phase(dev, card, err, kernel_ms, plain_ms, bounds):
    """Phase 40, kernels:halo1: `p2g3d(halo1=True)` against its plain
    version on each of stab3d-8M's 2 x 2 windows after 2 substeps (one
    call a window: the kernel takes a window's (L0, L1) pencils with
    positions local to it, as JAX's per-shard call does) and on a ragged
    APIC case (per channel, mass sum); `fold_rows0_halo` of it against raw
    `p2g3d_grid`'s halo sums of the same window; reruns; time and bound at
    the window's shape."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d

    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    scene = dataclasses.replace(scene8, cfg=dataclasses.replace(scene8.cfg, **STAB))
    sim = driver.Simulation(p8, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev,
                            devices=(2, 2))
    del p8
    sim.step_frame(2)
    ctx = fast_domain3d.context(sim.spec, sim.mesh)
    gspec, cfg, b = sim.spec.global_spec, scene.cfg, sim.state
    x0s, x1s = fast3d._shifts(b, cfg, ctx)
    fields = fast3d.prepped_fields(b, scene, gspec, b.x0 - x0s, b.x1 - x1s)
    counts = fast3d.pencil_counts(b)
    n, l0, g1 = sim.spec.n_shards, sim.spec.rows_per_shard0, gspec.rows1
    del sim, b, x0s, x1s
    g2, dx = cfg.num_grids, float(cfg.dx)
    kw = dict(apic=False, ext=True)
    raw_all = tk3.p2g3d_grid(fields, counts, g1, g2, dx, raw=True, shards=n, **kw)
    windows = [(f"stab3d-8M 2x2 window {s}",
                tuple(f[s * l0 : (s + 1) * l0] for f in fields),
                counts[s * l0 * g1 : (s + 1) * l0 * g1], g1, g2, dx, kw, raw_all[s])
               for s in range(n)]
    rf, _, rc, rg, rdx = ragged_prepped3d(dev, True, False, seed=13)
    rkw = dict(apic=True, ext=False)
    windows.append(("ragged apic7", rf, rc, rf[0].shape[1], rg, rdx, rkw,
                    tk3.p2g3d_grid(rf, rc, rf[0].shape[1], rg, rdx, raw=True, **rkw)[0]))
    worst = {"halo1": 0.0, "halo1_fold": 0.0, "halo1_ragged": 0.0, "halo1_ragged_fold": 0.0}
    for tag, f, c, gg1, gg2, ddx, kk, raw in windows:
        call = lambda: tk3.p2g3d(f, c, gg1, gg2, ddx, halo1=True, **kk)
        got = call()
        want = tk3.p2g3d_plain(f, c, gg1, gg2, ddx, halo1=True, **kk)
        err_c, rel_c = scaled_errors(got, want, axis=3)
        m_total = float(f[tk3.n_prepped(kk["apic"], False) - 1].double().sum())
        pou = abs(float(got[:, :, :, 6].double().sum())
                  - float(want[:, :, :, 6].double().sum())) / m_total
        del want
        err_f, rel_f = scaled_errors(tk3.fold_rows0_halo(got), raw, axis=2)
        say(f"[kernels:halo1 {tag}] p2g3d halo1 {tuple(got.shape)}: max_abs_err per channel "
            f"{['%.2e' % e for e in err_c]} scaled {['%.2e' % r for r in rel_c]} (tol "
            f"{KERNEL_REL_TOL}); mass sum against plain {pou:.3e} of the slots' mass (tol "
            f"{POU_REL_TOL}); fold_rows0_halo of it against raw p2g3d_grid "
            f"{tuple(raw.shape)} scaled {['%.2e' % r for r in rel_f]}  [{card}]")
        check(max(rel_c) <= KERNEL_REL_TOL, f"{tag}: p2g3d halo1 disagrees with plain")
        check(pou <= POU_REL_TOL, f"{tag}: p2g3d halo1 mass sum")
        check(max(rel_f) <= KERNEL_REL_TOL, f"{tag}: halo1's fold differs from raw p2g3d_grid")
        key = "halo1_ragged" if tag.startswith("ragged") else "halo1"
        worst[key] = max(worst[key], max(err_c))
        worst[f"{key}_fold"] = max(worst[f"{key}_fold"], max(err_f))
        if tag.endswith("window 0") or key == "halo1_ragged":
            rerun_equal(f"kernels:halo1 {tag}", "p2g3d", call, card)
        if tag.endswith("window 0"):
            live = int(c.sum())
            kernel_ms["p2g3d_halo1"] = cuda_ms(call, reps=10)
            plain_ms["p2g3d_halo1"] = cuda_ms(
                lambda: tk3.p2g3d_plain(f, c, gg1, gg2, ddx, halo1=True, **kk), reps=2, warm=1)
            bounds["p2g3d_halo1"] = bound(4 * (len(f) * live + c.numel() + got.numel()),
                                          live * 27 * got.shape[3] * 2)
            say(f"[kernels:halo1 {tag}] p2g3d halo1 at the window's shape "
                f"{kernel_ms['p2g3d_halo1']:.4f} ms (CUDA events, 10 calls), plain "
                f"{plain_ms['p2g3d_halo1']:.4f} ms, bound {bounds['p2g3d_halo1'][0]:.4f} ms "
                f"({bounds['p2g3d_halo1'][1]})  [{card}]")
        del got
        torch.cuda.empty_cache()
    for k, v in worst.items():
        err[f"p2g3d_{k}"] = v


def port_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 37-40's entries of the kernels line: p2g3d's halo1 mode
    (kernels:halo1; no path of the system runs it), raw p2g3d_grid and
    g2p3d on the two-axis mesh's (L0, L1) windows, and the scatter."""
    by_name = {k["name"]: k for k in kernels}
    by_name["p2g3d"].update({
        "halo1_max_abs_err": err["p2g3d_halo1"], "halo1_ms": kernel_ms["p2g3d_halo1"],
        "halo1_plain_ms": plain_ms["p2g3d_halo1"], "halo1_bound_ms": bounds["p2g3d_halo1"][0],
        "halo1_bound_by": bounds["p2g3d_halo1"][1],
        "halo1_ragged_max_abs_err": err["p2g3d_halo1_ragged"],
        "halo1_fold_max_abs_err": err["p2g3d_halo1_fold"],
        "halo1_rerun_bitwise_equal": RERUNS["p2g3d"]})
    for name in ("p2g3d_grid", "g2p3d"):
        for tag in ("slab8M", "stab3d-8M"):
            key = f"{name}_win2_{tag}"
            by_name[name].update({
                f"win2_{tag}_launches": launches[f"{name} win2 {tag}"],
                f"win2_{tag}_max_abs_err": err[key], f"win2_{tag}_ms": kernel_ms[key],
                f"win2_{tag}_plain_ms": plain_ms[key], f"win2_{tag}_bound_ms": bounds[key][0],
                f"win2_{tag}_bound_by": bounds[key][1]})
        by_name[name]["win2_cli_launches"] = launches[f"{name} win2 cli"]
    kernels.append({
        "name": "scatter", "route": "cuda", "source": "mpm_flip98a_tpu_torch/csrc/scatter.cu",
        "replaces": "mpm_flip98a_tpu/ops/transfer.py:70",
        "replaces_kind": "XLA scatter-add of the general path (not a Pallas kernel)",
        **{k: SCATTER[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        **{k: v for k, v in SCATTER.items() if k not in kernels[0]},
    })
    kernels.append({
        "name": "scatter_keys", "route": "cuda", "source": "mpm_flip98a_tpu_torch/csrc/scatter.cu",
        "replaces": "mpm_flip98a_tpu/ops/transfer.py:70",
        "replaces_kind": "the scatter's plan: one key a particle (not a Pallas kernel)",
        "launches": SCATTER["keys_launches"], "max_abs_err": 0.0 if SCATTER["keys_equal"] else 1.0,
        "ms": SCATTER["keys_ms"], "plain_ms": SCATTER["keys_plain_ms"],
        "bound_ms": SCATTER["keys_bound_ms"], "bound_by": SCATTER["keys_bound_by"],
        "library_ms": None,
    })


def port_phases(dev, card, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 37-40; returns the {"checkpoint": ..., "two_axis": ...}
    readings."""
    t0 = time.perf_counter()
    general_determinism(dev, card)
    say(f"[timing] main:general_determinism done in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    ck = checkpoint_phase(dev, card)
    say(f"[timing] main:checkpoint done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    two = two_axis_phase(dev, card, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] main:two_axis done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    halo1_phase(dev, card, err, kernel_ms, plain_ms, bounds)
    say(f"[timing] kernels:halo1 done in {time.perf_counter() - t1:.1f} s; phases 37-40 "
        f"{time.perf_counter() - t0:.1f} s")
    readings = {"checkpoint": ck, "two_axis": two, "scatter": SCATTER}
    say(json.dumps({"port13": readings}))
    return readings


# ---------------------------------------------------------------------------
# The fully fused 2D substep (MPM_P2G_GRID=1, MPM_FUSE2D_G2P=1) and p2g3d's
# stress mode
# ---------------------------------------------------------------------------

ROUTE_VARS = ("MPM_P2G_GRID", "MPM_FUSE2D_G2P")
ROUTES = {"default": ("0", "0"), "p2g_grid": ("1", "0"), "fuse_g2p": ("0", "1"),
          "both": ("1", "1")}
FUSED2D = {}                 # the {"fused2d": ...} line


@contextlib.contextmanager
def routes_env(setting):
    """fast2d's two route variables set to ROUTES[setting] for the block,
    restored after."""
    old = {k: os.environ.get(k) for k in ROUTE_VARS}
    os.environ.update(zip(ROUTE_VARS, ROUTES[setting]))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare_finished(tag, data, counts, kw, card):
    """`p2g_grid(raw=False)` against its plain version per channel, pad
    rows exactly zero, reruns bitwise equal, and against the node pass of
    its own raw sums; returns the worst absolute error."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    got = tk.p2g_grid(data, counts, **kw)
    want = tk.p2g_grid_plain(data, counts, **kw)
    err, rel = scaled_errors(got, want, axis=1)
    r = data.shape[0]
    pads = int(got[0].count_nonzero()) + int(got[r + 1 :].count_nonzero())
    node = {n: kw[n] for n in ("dt", "gx_", "gy_", "floor", "lo", "hi", "wall", "beta",
                               "colliders", "tcol")}
    raw_kw = {n: v for n, v in kw.items() if n not in node}
    raw = tk.p2g_grid(data, counts, raw=True, **raw_kw)[0]
    _, rel_raw = scaled_errors(got, tk.grid_update2d_plain(raw, r, **node, dx=kw["dx"]), axis=1)
    say(f"[kernels:fused2d {tag}] p2g_grid finished grid {tuple(got.shape)}: max_abs_err per "
        f"channel {['%.3e' % e for e in err]}, scaled {['%.2e' % x for x in rel]} (tol "
        f"{KERNEL_REL_TOL}); non-zero pad entries {pads} (must be 0); against the node pass "
        f"of its raw sums {max(rel_raw):.2e}  [{card}]")
    check(max(rel) <= KERNEL_REL_TOL, f"{tag}: p2g_grid (non-raw) disagrees with its plain version")
    check(max(rel_raw) <= KERNEL_REL_TOL, f"{tag}: p2g_grid (non-raw) is not its raw sums finished")
    check(pads == 0, f"{tag}: p2g_grid (non-raw) wrote {pads} non-zero pad entries")
    rerun_equal(f"kernels:fused2d {tag}", "p2g_grid_finished",
                lambda: tk.p2g_grid(data, counts, **kw), card)
    return max(err), got


def compare_g2p_update(tag, pdata8, counts, grid, dx, dinv, prepadded, card):
    """`g2p(update=True)` against its plain version (C scaled by one
    term, dinv dx |v|max, as compare_g2p does), the dead slots' fill
    exact, reruns bitwise equal; returns the worst absolute error."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    kw = dict(prepadded=prepadded, update=True, alpha=0.98, dtv=BENCH["dt"])
    got = tk.g2p(pdata8, counts, grid, dx, dinv, **kw)
    want = tk.g2p_plain(pdata8, counts, grid, dx, dinv, **kw)
    vmax = grid.movedim(-2, 0)[:2].reshape(2, -1).abs().amax(dim=1).double()
    scale = want.abs().amax(dim=(0, 2)).double()
    scale[4:8] = (dinv * dx * vmax).repeat_interleave(2)
    err, rel = scaled_errors(got, want, axis=1, scale=scale)
    dead = torch.arange(pdata8.shape[2], device=counts.device)[None, :] >= counts[:, None]
    fill_ok = (torch.equal(got[:, :2].transpose(0, 1)[:, dead],
                           pdata8[:, 6:8].transpose(0, 1)[:, dead])
               and not bool(got[:, 2:8].transpose(0, 1)[:, dead].any())
               and bool((got[:, 8][dead] == 1.0).all()))
    say(f"[kernels:fused2d {tag}] g2p update mode, prepadded {prepadded}, grid "
        f"{tuple(grid.shape)}: max_abs_err per channel {['%.3e' % e for e in err]}, scaled "
        f"{['%.2e' % x for x in rel]} (tol {KERNEL_REL_TOL}); {int(dead.sum())} dead slots "
        f"filled exactly {fill_ok}  [{card}]")
    check(max(rel) <= KERNEL_REL_TOL, f"{tag}: g2p (update) disagrees with its plain version")
    check(fill_ok, f"{tag}: g2p (update) dead slots not x / 0 / 1")
    rerun_equal(f"kernels:fused2d {tag}", "g2p_update",
                lambda: tk.g2p(pdata8, counts, grid, dx, dinv, **kw), card)
    return max(err)


def kernels_fused2d(dev, card, err, kernel_ms, plain_ms, bounds):
    """Phase 41, kernels:fused2d; returns the bench particles and scene."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.parallel import fast_domain

    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC)
    cfg_stab = MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC)
    p_big, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p_big)
    b = fast2d.run(fast2d.from_particles(p_big, cfg, spec, dev), scene, spec, 20)
    g, dx = cfg.num_grids, float(cfg.dx)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    sdata, pdata8, counts = fast2d.transfer_inputs(b, scene, update=True)
    kw = dict(fused=True, **fast2d.p2g_args(scene), **fast2d.p2g_grid_args(scene))
    err["p2g_grid_finished"], finished = compare_finished("bench", sdata, counts, kw, card)
    r, _, k = sdata.shape
    live = int(counts.sum())
    nodes = (r + 4) * g
    kernel_ms["p2g_grid_finished"] = cuda_ms(lambda: tk.p2g_grid(sdata, counts, **kw))
    plain_ms["p2g_grid_finished"] = cuda_ms(lambda: tk.p2g_grid_plain(sdata, counts, **kw),
                                            reps=3, warm=1)
    # Live slots' 11 fields + counts in, the finished (R + 4, 4, G) grid out;
    # 9 taps x 5 channels of multiply-adds per live slot and ~20 operations
    # of stress, ~15 per node.
    bounds["p2g_grid_finished"] = bound(4 * (11 * live + r + 4 * nodes),
                                        live * (9 * 5 * 2 + 20) + 15 * nodes)
    # g2p's update mode: unpadded on the default route's grid, prepadded on
    # p2g_grid's finished grid, and on 4 shards' halo-synced grids.
    grid4 = fast2d._grid(sdata, counts, scene, False, None)
    err["g2p_update"] = compare_g2p_update("bench", pdata8, counts, grid4, dx, dinv, False, card)
    err["g2p_update_prepadded"] = compare_g2p_update("bench", pdata8, counts, finished[None],
                                                     dx, dinv, True, card)
    kw_u = dict(update=True, alpha=0.98, dtv=BENCH["dt"])
    kernel_ms["g2p_update"] = cuda_ms(lambda: tk.g2p(pdata8, counts, grid4, dx, dinv, **kw_u))
    plain_ms["g2p_update"] = cuda_ms(
        lambda: tk.g2p_plain(pdata8, counts, grid4, dx, dinv, **kw_u), reps=3, warm=1)
    kernel_ms["g2p_update_prepadded"] = cuda_ms(
        lambda: tk.g2p(pdata8, counts, finished[None], dx, dinv, prepadded=True, **kw_u))
    # Live slots' 8 rows, dead slots' x (2) + counts + the grid in; every
    # slot's 9 rows out; 9 taps x 8 sums and ~15 operations of update per
    # live slot.
    bounds["g2p_update"] = bound(
        4 * (8 * live + 2 * (r * k - live) + r + 4 * r * g + 9 * r * k), live * (9 * 8 * 2 + 15))
    sim4 = driver.Simulation(p_big, scene, path="fast", out_dir=tempfile.gettempdir(),
                             device=dev, devices=4)
    sim4.step_frame(20)
    ctx = fast_domain.FastDomainCtx(sim4.mesh, sim4.spec.rows_per_shard)
    b4 = sim4.state
    d4, pdata8_s, c4 = fast2d.transfer_inputs(b4, scene, ctx, update=True)
    grid_s = fast2d._grid(d4, c4, scene, False, ctx)
    err["g2p_update_sharded"] = compare_g2p_update("bench x4", pdata8_s, c4, grid_s, dx, dinv,
                                                   True, card)
    kernel_ms["g2p_update_sharded"] = cuda_ms(
        lambda: tk.g2p(pdata8_s, c4, grid_s, dx, dinv, prepadded=True, **kw_u))
    del sim4, b4, d4, c4, grid_s, pdata8_s, grid4, finished, pdata8

    # stab1M: the prepped 9-channel branch with the penalty EBC.
    p_s, scene_s = scenes.dam_break_2d(cfg_stab, dtype=np.float32)
    spec_s = fast2d.FastSpec.for_particles(cfg_stab, p_s)
    b_s = fast2d.run(fast2d.from_particles(p_s, cfg_stab, spec_s, dev), scene_s, spec_s, 20)
    pdata, _, counts_s = fast2d.transfer_inputs(b_s, scene_s)
    kw_s = dict(fused=False, **fast2d.p2g_args(scene_s), **fast2d.p2g_grid_args(scene_s))
    check(kw_s["wall"] == "penalty" and pdata.shape[1] == 17, "stab1M: not the prepped penalty")
    err["p2g_grid_finished_prepped"], _ = compare_finished("stab1M", pdata, counts_s, kw_s, card)
    kernel_ms["p2g_grid_finished_prepped"] = cuda_ms(lambda: tk.p2g_grid(pdata, counts_s, **kw_s))
    live_s = int(counts_s.sum())
    bounds["p2g_grid_finished_prepped"] = bound(
        4 * (17 * live_s + r + 7 * nodes), live_s * 9 * 9 * 2 + 25 * nodes)
    del p_s, b_s, pdata, counts_s

    # plow2d after 200 substeps, its paddle (a kinematic sticky cylinder
    # sweeping at 0.25 l/s from x = 0.8 l) placed by tcol = 2.4 s at 0.2 l,
    # inside the column.
    p_p, scene_p = driver.SCENARIOS["plow2d"]()
    cfg_p = scene_p.cfg
    spec_p = fast2d.FastSpec.for_particles(cfg_p, p_p)
    b_p = fast2d.run(fast2d.from_particles(p_p, cfg_p, spec_p, dev), scene_p, spec_p, 200, t0=0.0)
    tcol = float(np.float32(2.4))
    dp, _, cp = fast2d.transfer_inputs(b_p, scene_p)
    kw_p = dict(fused=fast2d.uses_fused(scene_p), **fast2d.p2g_args(scene_p),
                **fast2d.p2g_grid_args(scene_p, tcol))
    check(kw_p["tcol"] == tcol and len(kw_p["colliders"]) == 1, "plow2d: no moving collider")
    err["p2g_grid_finished_colliders"], got_p = compare_finished(
        "plow2d paddle", dp, cp, kw_p, card)
    free = tk.p2g_grid(dp, cp, **{**kw_p, "colliders": ()})
    moved = int((free[:, :2] != got_p[:, :2]).any(dim=1).sum())
    say(f"[kernels:fused2d plow2d paddle] nodes whose v_new the paddle changed at t = {tcol!r}: "
        f"{moved}  [{card}]")
    check(moved > 0, "plow2d: the paddle changed no node")
    del b_p, dp, cp, free, got_p
    for name in ("p2g_grid_finished", "p2g_grid_finished_prepped", "g2p_update"):
        say(f"[kernels:fused2d] {name}: kernel {kernel_ms[name]:.4f} ms (CUDA events, 20 calls)"
            f"{', plain %.4f ms (3 calls)' % plain_ms[name] if name in plain_ms else ''}, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")
    say(f"[kernels:fused2d] g2p update prepadded {kernel_ms['g2p_update_prepadded']:.4f} ms, on "
        f"4 shards {kernel_ms['g2p_update_sharded']:.4f} ms  [{card}]")
    torch.cuda.empty_cache()
    return p_big, scene


def profile_route(path, run_n, n_sub, wall_ms, tag, card):
    """profile_calls, and the device kernels a substep from the same trace."""
    from torch.profiler import ProfilerActivity, profile

    busy = profile_calls(path, run_n, n_sub, wall_ms, tag, card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_n(n_sub)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    say(f"[timing:{tag}] device kernels (and copies) a substep: {n / n_sub:.1f}  [{card}]")
    return busy, n / n_sub


def main_fused2d(dev, card, io_ok, profile_dir, p_big, scene, launches):
    """Phase 42, main:fused2d."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.models import fast2d
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    tmp = tempfile.gettempdir()
    mass0 = float(p_big.mass.to(torch.float32).double().sum())
    sims, one = {}, {}
    for setting in ROUTES:
        with routes_env(setting):
            sims[setting] = sim = driver.Simulation(p_big, scene, path="fast", out_dir=tmp,
                                                    device=dev)
            check(fast2d.routes(scene) == tuple(v == "1" for v in ROUTES[setting]),
                  f"{setting}: fast2d.routes reads {fast2d.routes(scene)}")
            reset_counts()
            sim.run(1, 1, gif=False, verbose=False, write_frames=False)
            one[setting] = dataclasses.replace(sim.state)
            sim.run(1, 99, gif=False, verbose=False, write_frames=False)
            torch.cuda.synchronize()
            got = {**kernel_counts(), **tk3.MODE_LAUNCHES}
        grid, fuse = (v == "1" for v in ROUTES[setting])
        check(got["p2g_grid"] == (100 if grid else 0) and got["g2p"] == 100
              and got["p2g_fused"] == (0 if grid else 100) and got["p2g"] == 0,
              f"{setting}: launches {got} for 100 substeps")
        launches[f"fused2d {setting}"] = got
        if setting != "default":
            ref = one["default"]
            x1 = float(max((getattr(one[setting], n) - getattr(ref, n)).abs().max()
                           for n in ("x0", "x1")))
            e1 = state_errors(one[setting], ref, 2)
            say(f"[main:fused2d {setting}] bench 1M, 1 substep against the default route: x "
                f"{x1:.3e} (tol 1e-6), v {e1['v']:.3e}, C {e1['C']:.3e} of their max (tol "
                f"{KERNEL_REL_TOL}), J {e1['J']:.3e} (tol 1e-6); launches of 100 substeps "
                f"{got}  [{card}]")
            check(x1 <= 1e-6 and e1["v"] <= KERNEL_REL_TOL and e1["C"] <= KERNEL_REL_TOL
                  and e1["J"] <= 1e-6, f"{setting}: left the default route after 1 substep")
        host_checks(f"fused2d {setting}", sim, p_big.n, mass0, card)
        if fuse:
            f00 = sim.state.F00[sim.state.mask > 0]
            check(bool((f00 == 1.0).all()), f"{setting}: the fused G2P changed F")
    del one
    # Reruns: 2 substeps twice from the same state under each route.
    b0, spec = sims["default"].state, sims["default"].spec
    for setting in ("p2g_grid", "fuse_g2p", "both"):
        with routes_env(setting):
            first = fast2d.run(b0, scene, spec, 2)
            again = fast2d.run(b0, scene, spec, 2)
        same = all(torch.equal(getattr(first, f.name), getattr(again, f.name))
                   for f in dataclasses.fields(first))
        say(f"[main:fused2d {setting}] two runs of 2 substeps from one state bitwise equal: "
            f"{same}  [{card}]")
        check(same, f"{setting}: reruns differ")
    # ms per substep: 3 x 100 substeps from one state, the four routes in turn.
    runs = {s: [] for s in ROUTES}
    for setting in ROUTES:
        with routes_env(setting):
            time_run(fast2d, b0, scene, spec, 3, False)
    for _ in range(3):
        for setting in ROUTES:
            with routes_env(setting):
                runs[setting].append(time_run(fast2d, b0, scene, spec, 100, False))
    ms = {s: 1e3 * float(np.median(t)) / 100 for s, t in runs.items()}
    for setting, t in runs.items():
        say(f"[timing:fused2d {setting}] bench 1M: {ms[setting]:.4f} ms/substep (median of 3 x "
            f"100, the four routes in turn; runs {[round(10 * x, 4) for x in t]} ms/substep)"
            f"  [{card}]")
    FUSED2D["ms_per_substep"] = ms
    if profile_dir:
        FUSED2D["busy_ms"], FUSED2D["kernels_per_substep"] = {}, {}
        for setting in ROUTES:
            with routes_env(setting):
                FUSED2D["busy_ms"][setting], FUSED2D["kernels_per_substep"][setting] = (
                    profile_route(os.path.join(profile_dir, f"profile_fused2d_{setting}.txt"),
                                  lambda n: fast2d.run(b0, scene, spec, n), 20, ms[setting],
                                  f"fused2d {setting}", card))
    del sims, b0
    torch.cuda.empty_cache()
    # The CLIs with both variables; bench 1M in 4 shards with the fused G2P.
    say(f"[main:fused2d] the dam2d_flip98 and plow2d CLIs with MPM_P2G_GRID=1 "
        f"MPM_FUSE2D_G2P=1  [{card}]")
    with routes_env("both"):
        for scenario in ("dam2d_flip98", "plow2d"):
            run_collider_cli(dev, card, io_ok, scenario, 2, 200, ("p2g_grid", "g2p"),
                             ("p2g_fused", "p2g"), {})
    with routes_env("fuse_g2p"):
        sim, ref, got = sharded_against_single("bench fused g2p", p_big, scene, dev, 4, 100,
                                               card)
        del ref
        # The sharded run alone, counted: one raw p2g_grid and one update-mode
        # g2p per substep, no p2g_fused.
        reset_counts()
        sim.step_frame(20)
        torch.cuda.synchronize()
        got = kernel_counts()
        launches["fused2d fuse_g2p x4"] = got
        say(f"[main:fused2d fuse_g2p x4] the sharded run alone, 20 substeps: launches {got}"
            f"  [{card}]")
        check(got["p2g_grid"] == got["g2p"] == 20 and sum(got.values()) == 40,
              f"sharded fused g2p: launches {got} for 20 substeps of the sharded run alone")
        f00 = sim.state.F00[sim.state.mask > 0]
        check(bool((f00 == 1.0).all()), "sharded fused g2p: F changed")
    del sim
    torch.cuda.empty_cache()


def kernels_stress3d(dev, card, err, kernel_ms, plain_ms, bounds, launches):
    """Phase 43, kernels:stress3d.  Its 5 substeps of the 8M slab on the
    3D fused path are a main-path window for p2g3d's stress mode."""
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    cfg8 = scene8.cfg
    spec8 = fast3d.FastSpec3D.for_particles(cfg8, p8)
    b8 = fast3d.from_particles(p8, cfg8, spec8, dev)
    reset_counts()
    b8 = fast3d.run(b8, scene8, spec8, 5)
    torch.cuda.synchronize()
    got = launches["slab8M 5 substeps"] = {**kernel_counts(), **tk3.MODE_LAUNCHES}
    say(f"[kernels:stress3d slab8M] launches of 5 substeps on the 3D fused path: {got}  [{card}]")
    check(got["p2g3d_grid"] == got["g2p3d"] == 5, f"slab8M: launches {got} for 5 substeps")
    del p8
    planes, counts, _, _ = fast3d.transfer_inputs(b8, spec8, cfg8)
    a = fast3d.p2g_args(scene8, raw=True)
    g2, dx = a.pop("g2"), a.pop("dx")
    r0, r1, k = planes[0].shape
    check(a["stress"] == "linear", f"slab 8M: stress {a['stress']}")
    got = tk3.p2g3d(planes, counts, r1, g2, dx, **a)
    want = tk3.p2g3d_plain(planes, counts, r1, g2, dx, stress=a["stress"], apic=a["apic"],
                           **{n: a[n] for n in ("kb", "mu", "gamma", "fa")})
    e, rel = scaled_errors(got, want, axis=3)
    del want
    say(f"[kernels:stress3d slab8M] p2g3d stress mode ({a['stress']}, apic {a['apic']}) "
        f"{tuple(got.shape)}: max_abs_err per channel {['%.3e' % x for x in e]}, scaled "
        f"{['%.2e' % x for x in rel]} (tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel) <= KERNEL_REL_TOL, "slab8M: p2g3d (stress) disagrees with its plain version")
    err["p2g3d_stress"] = max(e)
    del got
    rerun_equal("kernels:stress3d slab8M", "p2g3d", lambda: tk3.p2g3d(
        planes, counts, r1, g2, dx, **a), card)
    kernel_ms["p2g3d_stress"] = cuda_ms(lambda: tk3.p2g3d(planes, counts, r1, g2, dx, **a),
                                        reps=5, warm=1)
    plain_ms["p2g3d_stress"] = cuda_ms(lambda: tk3.p2g3d_plain(
        planes, counts, r1, g2, dx, stress=a["stress"], apic=a["apic"],
        **{n: a[n] for n in ("kb", "mu", "gamma", "fa")}), reps=1, warm=0)
    live = int(counts.sum())
    # Live slots' 18 planes + counts in, the (R0, 5, G1, 7, G2) expanded
    # sums out; 27 taps x 7 channels of multiply-adds and ~60 operations of
    # stress per live slot.
    bounds["p2g3d_stress"] = bound(4 * (18 * live + r0 * r1 + r0 * 5 * r1 * 7 * g2),
                                   live * (27 * 7 * 2 + 60))
    # Its fold against p2g3d_grid's stress mode: fold_rows0_halo of the
    # halo1 output is raw p2g3d_grid's (R0 + 4, R1 + 4) halo sums.
    halo = tk3.fold_rows0_halo(tk3.p2g3d(planes, counts, r1, g2, dx, halo1=True, **a))
    raw = tk3.p2g3d_grid(planes, counts, r1, g2, dx, raw=True, **a)[0]
    _, rel_f = scaled_errors(halo, raw, axis=2)
    err["p2g3d_stress_fold"] = float((halo - raw).abs().max())
    say(f"[kernels:stress3d slab8M] fold_rows0_halo of p2g3d(stress, halo1) against raw "
        f"p2g3d_grid (stress): max_abs_err {err['p2g3d_stress_fold']:.3e}, worst channel "
        f"{max(rel_f):.2e} of its max (tol {KERNEL_REL_TOL}); p2g3d "
        f"{kernel_ms['p2g3d_stress']:.4f} ms, plain {plain_ms['p2g3d_stress']:.4f} ms, bound "
        f"{bounds['p2g3d_stress'][0]:.4f} ms ({bounds['p2g3d_stress'][1]})  [{card}]")
    check(max(rel_f) <= KERNEL_REL_TOL, "slab8M: p2g3d's stress fold is not p2g3d_grid's")
    del halo, raw, planes, counts, b8
    torch.cuda.empty_cache()
    # A ragged APIC Tait case.
    rplanes, _, rcounts, _, rg, rdx = ragged_inputs3d(dev)
    ra = dict(apic=True, stress="tait", kb=a["kb"], mu=a["mu"], gamma=a["gamma"],
              fa=-cfg8.dt * 4.0 / rdx**2)
    rr1 = rplanes[0].shape[1]
    got = tk3.p2g3d(rplanes, rcounts, rr1, rg, rdx, **ra)
    want = tk3.p2g3d_plain(rplanes, rcounts, rr1, rg, rdx, **ra)
    e, rel = scaled_errors(got, want, axis=3)
    say(f"[kernels:stress3d ragged apic tait] p2g3d {tuple(got.shape)}: scaled "
        f"{['%.2e' % x for x in rel]} (tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel) <= KERNEL_REL_TOL, "ragged: p2g3d (stress, APIC Tait) disagrees with plain")
    err["p2g3d_stress_ragged"] = max(e)
    rerun_equal("kernels:stress3d ragged apic tait", "p2g3d",
                lambda: tk3.p2g3d(rplanes, rcounts, rr1, rg, rdx, **ra), card)


def fused2d_phases(dev, card, io_ok, profile_dir, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 41-43; returns the {"fused2d": ...} readings."""
    t0 = time.perf_counter()
    p_big, scene = kernels_fused2d(dev, card, err, kernel_ms, plain_ms, bounds)
    say(f"[timing] kernels:fused2d done in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    main_fused2d(dev, card, io_ok, profile_dir, p_big, scene, launches)
    say(f"[timing] main:fused2d done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    kernels_stress3d(dev, card, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] kernels:stress3d done in {time.perf_counter() - t1:.1f} s; phases 41-43 "
        f"{time.perf_counter() - t0:.1f} s")
    say(json.dumps({"fused2d": FUSED2D}))
    return FUSED2D


def fused2d_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 41-43's entries of the kernels line: p2g_grid's non-raw mode,
    g2p's update mode (launched on main:fused2d's routes) and p2g3d's
    stress mode (no path of the system runs it: its launches are counted
    on main:fused2d's four routes and kernels:stress3d's 5 slab substeps)."""
    by_name = {k["name"]: k for k in kernels}
    for name, mode, ran in (("p2g_grid", "p2g_grid_finished", ("p2g_grid", "both")),
                            ("g2p", "g2p_update", ("g2p", "fuse_g2p"))):
        by_name[name].update({
            f"{mode[len(name) + 1:]}_{key}": val for key, val in (
                ("launches", launches[f"fused2d {ran[1]}"][ran[0]]),
                ("max_abs_err", err[mode]), ("ms", kernel_ms[mode]),
                ("plain_ms", plain_ms[mode]), ("bound_ms", bounds[mode][0]),
                ("bound_by", bounds[mode][1]))})
    by_name["p2g_grid"].update({
        "finished_rerun_bitwise_equal": RERUNS["p2g_grid_finished"],
        "finished_prepped_max_abs_err": err["p2g_grid_finished_prepped"],
        "finished_prepped_ms": kernel_ms["p2g_grid_finished_prepped"],
        "finished_prepped_bound_ms": bounds["p2g_grid_finished_prepped"][0],
        "finished_prepped_bound_by": bounds["p2g_grid_finished_prepped"][1],
        "finished_colliders_max_abs_err": err["p2g_grid_finished_colliders"]})
    by_name["g2p"].update({
        "update_rerun_bitwise_equal": RERUNS["g2p_update"],
        "update_prepadded_max_abs_err": err["g2p_update_prepadded"],
        "update_prepadded_ms": kernel_ms["g2p_update_prepadded"],
        "update_sharded_max_abs_err": err["g2p_update_sharded"],
        "update_sharded_ms": kernel_ms["g2p_update_sharded"],
        "update_sharded_launches": launches["fused2d fuse_g2p x4"]["g2p"]})
    by_name["p2g3d"].update({
        "stress_launches": sum(launches[w]["p2g3d_stress"] for w in (
            *(f"fused2d {s}" for s in ROUTES), "slab8M 5 substeps")),
        "stress_on_a_path": False,
        "stress_max_abs_err": err["p2g3d_stress"], "stress_ms": kernel_ms["p2g3d_stress"],
        "stress_plain_ms": plain_ms["p2g3d_stress"],
        "stress_bound_ms": bounds["p2g3d_stress"][0],
        "stress_bound_by": bounds["p2g3d_stress"][1],
        "stress_fold_max_abs_err": err["p2g3d_stress_fold"],
        "stress_ragged_max_abs_err": err["p2g3d_stress_ragged"]})


# ---------------------------------------------------------------------------
# The general path's multi-device strategies on a rank mesh: the slab domain
# (parallel/domain.py) and the replicated grid (parallel/replicated.py)
# ---------------------------------------------------------------------------

# Every rank of phases 44-48 computes on cuda:0, the one card; gloo moves the
# ranks' blocks, staged through host memory by RankMesh.  nccl needs a card
# per rank (it refuses ranks that share one: checked in main:domain).
RANK_BACKEND = "gloo"
RANK_TIMEOUT_S = 120.0
# The migration case: tests/test_parallel_domain.py's 37^2 dam break at dt
# 4e-5, its column widened to 32 x 32 particles and thrown at 3 m/s so that
# particles cross the first slab line within 100 substeps.  The unthrown
# collapse first migrates after 2,700 substeps at 4 shards (the JAX domain
# on the CPU), too long for this script.
MIGRATE_THROWN = dict(num_grids=37, dt=4e-5, num_particles_x=32, num_particles_y=32,
                      fluid_width=0.11)
FAST37 = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)
RANK_FIELDS = ("x", "v", "C", "J", "mass")
# Against one device, slot for slot, after the run (x, v absolute; the
# JAX tests' bounds: tests/test_parallel_domain.py:36-45,
# tests/test_surface_tension.py:80-97, tests/test_projection.py:125-153,
# tests/test_parallel_replicated.py:28-38); at scale the sharded gates
# (x absolute; v, C relative to their max).
DOMAIN_TOL = {"x": 1e-12, "v": 1e-10}
EXT_TOL = {"csf": {"x": 1e-12}, "projection": {"x": 1e-8, "v": 1e-7},
           "obstacle": {"x": 1e-12, "v": 1e-10}}
REPLICATED_TOL = {"x": 1e-10, "v": 1e-8, "J": 1e-10}
SCALE_TOL = {"x": 1e-6, "v": KERNEL_REL_TOL, "C": KERNEL_REL_TOL}
ENSEMBLE_TOL = 1e-10          # float64 mean and std of x after the migration run
RANKS = {}                    # the {"ranks": ...} line


def _traffic(mesh) -> dict:
    return {tag: [t.calls, t.bytes, t.seconds] for tag, t in mesh.traffic.items()}


def rank_jobs(mesh, jobs):
    """The rank worker of phases 44-47 (one process a rank, started by
    `launch.run_ranks`; it prints nothing).  Each job (a dict) runs
    `kind` ("domain" or "replicated") from the host particles `start` for
    `n` substeps and returns this rank's RANK_FIELDS, `dropped`, the
    scatter's launches and the transfer kernels' in that run, the traffic
    by tag; with `rerun`, whether a second run from the same start is
    bitwise equal; with `timed` (reps, substeps), the ms per substep and
    the traffic of each timed run (rank 0 under torch.profiler after them
    with `profile`); the peak device memory."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter
    from mpm_flip98a_tpu_torch.parallel import domain, replicated
    from mpm_flip98a_tpu_torch.state import Particles

    dev, out = mesh.device, []
    names = [f.name for f in dataclasses.fields(Particles)]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for job in jobs:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        p = Particles(**{k: torch.from_numpy(v) for k, v in job["start"].items()})
        if job["kind"] == "domain":
            start, _ = domain.distribute(p, job["scene"], job["spec"], mesh)
            run = domain.make_run(job["scene"], job["spec"], mesh)
            parts = lambda s: s.particles
        else:
            start = replicated.shard_particles(p, mesh)
            run = replicated.make_run(job["scene"], mesh)
            parts = lambda s: s
        del p
        scatter.reset_launches()
        reset_counts()
        mesh.traffic.clear()
        t0 = time.perf_counter()
        state = run(start, job["n"])
        sync()
        rec = {"seconds": time.perf_counter() - t0, "launches": scatter.LAUNCHES["scatter"],
               "transfer_launches": sum(kernel_counts().values()), "traffic": _traffic(mesh),
               **{f: getattr(parts(state), f).cpu().numpy() for f in RANK_FIELDS}}
        if job["kind"] == "domain":
            rec["dropped"] = state.dropped.cpu().numpy()
        if job.get("rerun"):
            again = run(start, job["n"])
            rec["rerun_equal"] = all(torch.equal(getattr(parts(state), f), getattr(parts(again), f))
                                     for f in names)
            if job["kind"] == "domain":
                rec["rerun_equal"] &= torch.equal(state.dropped, again.dropped)
            del again
        del start
        if job.get("timed"):
            reps, n = job["timed"]
            rec["ms_runs"], rec["traffic_runs"] = [], []
            for _ in range(reps):
                mesh.psum(torch.zeros(1, device=dev))      # the ranks start together
                mesh.traffic.clear()
                sync()
                t0 = time.perf_counter()
                state = run(state, n)
                sync()
                rec["ms_runs"].append(1e3 * (time.perf_counter() - t0) / n)
                rec["traffic_runs"].append(_traffic(mesh))
            if job.get("profile"):
                rec["profile"] = profile_rank(mesh, lambda k: run(state, k), 5)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
        out.append(rec)
        del state
    return out


def profile_rank(mesh, run_n, n_sub):
    """Rank 0 under torch.profiler for `n_sub` substeps while the other
    ranks run them unprofiled: (device busy ms per substep, the wall ms
    per substep, the table by device time); None on the other ranks."""
    from torch.profiler import ProfilerActivity, profile

    mesh.psum(torch.zeros(1, device=mesh.device))
    if mesh.rank:
        run_n(n_sub)
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_n(n_sub)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n_sub
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if str(e.device_type).endswith("CUDA")) / 1e3 / n_sub
    return busy, wall, events.table(sort_by="cuda_time_total", row_limit=30)


def host_fields(p) -> dict:
    return {f.name: getattr(p, f.name).cpu().numpy() for f in dataclasses.fields(p)}


def merged(per_rank, j) -> dict:
    """Job j's fields of every rank, concatenated in rank order."""
    return {k: np.concatenate([r[j][k] for r in per_rank]) for k in RANK_FIELDS + (
        ("dropped",) if "dropped" in per_rank[0][j] else ())}


def scatters_per_substep(cfg) -> int:
    """The general substep's scatters: the momentum sums, with F-bar the
    cell sums, with mixing the projection pass."""
    return 1 + int(cfg.use_fbar) + int(cfg.pressure_mixing_ratio > 0.0)


def slot_errors(got, ref, perm, scaled=()) -> dict:
    """Worst |got[perm] - ref| per field (over the field's max |ref| for
    the `scaled` ones)."""
    out = {}
    for f, want in ref.items():
        err = float(np.abs(got[f][perm].astype(np.float64) - want).max())
        out[f] = err / max(float(np.abs(want).max()), 1e-30) if f in scaled else err
    return out


def rank_summary(tag, per_rank, j, n_sub, cfg, card):
    """Checks and prints what every rank of job j reported: the scatter
    launched once per scatter of the window and no transfer kernel, no
    particle dropped; returns the per-rank launches."""
    recs = [r[j] for r in per_rank]
    launches = [r["launches"] for r in recs]
    want = n_sub * scatters_per_substep(cfg)
    dropped = [int(r["dropped"].sum()) for r in recs if "dropped" in r]
    say(f"[ranks {tag}] {len(recs)} ranks, {n_sub} substeps: scatter launches per rank "
        f"{launches} (want {want} each: {scatters_per_substep(cfg)} a substep), transfer "
        f"kernels {[r['transfer_launches'] for r in recs]}, dropped {dropped} (bound 0), "
        f"host s per rank {[round(r['seconds'], 3) for r in recs]}, peak device memory per "
        f"rank {[r['peak_bytes'] for r in recs]} bytes  [{card}]")
    check(all(n == want for n in launches), f"{tag}: scatter launches {launches}, want {want}")
    check(not any(r["transfer_launches"] for r in recs), f"{tag}: a transfer kernel ran")
    check(not any(dropped), f"{tag}: dropped {dropped}")
    if "rerun_equal" in recs[0]:
        equal = all(r["rerun_equal"] for r in recs)
        say(f"[ranks {tag}] a second run from the same start bitwise equal on every rank: "
            f"{equal}")
        check(equal, f"{tag}: two runs on the ranks differ")
    return launches


def rank_timing(tag, per_rank, j, n_sub, ref_ms, card, exchange_tags):
    """ms per substep of the timed runs (the slowest rank of each run),
    each rank's exchange ms and bytes per substep, against one device."""
    recs = [r[j] for r in per_rank]
    runs = [max(r["ms_runs"][k] for r in recs) for k in range(len(recs[0]["ms_runs"]))]
    ex_ms = [float(np.median([sum(t[g][2] for g in exchange_tags if g in t)
                              for t in r["traffic_runs"]])) * 1e3 / n_sub for r in recs]
    ex_bytes = [sum(r["traffic_runs"][0][g][1] for g in exchange_tags
                    if g in r["traffic_runs"][0]) / n_sub for r in recs]
    ex_calls = [sum(r["traffic_runs"][0][g][0] for g in exchange_tags
                    if g in r["traffic_runs"][0]) / n_sub for r in recs]
    med = float(np.median(runs))
    say(f"[timing:ranks {tag}] {len(recs)} ranks on one card: {med:.4f} ms/substep (median of "
        f"{len(runs)} x {n_sub}, the slowest rank's; runs {[round(x, 4) for x in runs]}) against "
        f"one device {ref_ms[0]:.4f} (runs {[round(x, 4) for x in ref_ms[1]]}); exchanges "
        f"({'+'.join(exchange_tags)}) per rank per substep: {[round(x, 4) for x in ex_ms]} ms, "
        f"{ex_bytes} bytes sent in {ex_calls} calls; peak device memory per rank "
        f"{[r['peak_bytes'] for r in recs]} bytes  [{card}]")
    return {"ms": med, "runs": runs, "one_device_ms": ref_ms[0], "one_device_runs": ref_ms[1],
            "exchange_ms_per_rank": ex_ms, "exchange_bytes_per_rank": ex_bytes,
            "exchange_calls_per_rank": ex_calls,
            "peak_bytes_per_rank": [r["peak_bytes"] for r in recs]}


def rank_profile(tag, per_rank, j, profile_dir, card):
    got = per_rank[0][j].get("profile")
    if not got:
        return None
    busy, wall, table = got
    path = os.path.join(profile_dir, f"profile_ranks_{tag}_rank0.txt")
    with open(path, "w") as f:
        f.write(f"{card}\n{table}\n")
    say(f"[timing:ranks {tag}] rank 0 profile written to {path}: device busy {busy:.4f} "
        f"ms/substep against {wall:.4f} ms/substep profiled (idle share "
        f"{1.0 - busy / wall:.3f})  [{card}]")
    return {"busy_ms": busy, "profiled_wall_ms": wall, "idle_share": 1.0 - busy / wall}


def nccl_refusal(dev) -> bool:
    """Two ranks asked for nccl on this one card: the RankMesh must raise
    and name gloo, never switch backend itself."""
    from mpm_flip98a_tpu_torch.parallel import launch

    try:
        launch.run_ranks(launch.mesh_calls, 2, device=dev, backend="nccl",
                         timeout_s=RANK_TIMEOUT_S, args=([],))
        refusal = None
    except launch.RankError as e:
        refusal = str(e)
    ok = refusal is not None and "share one card" in refusal and "backend='gloo'" in refusal
    say(f"[main:domain] a RankMesh asked for nccl with 2 ranks on this card raises: {ok} "
        f"({refusal.strip().splitlines()[-1] if refusal else 'no error'})")
    check(ok, "an nccl mesh of two ranks on one card did not raise")
    return ok


def ranks_phases(dev, card, profile_dir):
    """Phases 44-48: the general path's slab domain and replicated grid on
    ranks of a gloo process group, every rank on this card, against the
    single-device general path; the nccl refusal; the port's dryrun."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.dryrun import dryrun_multichip
    from mpm_flip98a_tpu_torch.models import scenes, stabilized
    from mpm_flip98a_tpu_torch.parallel import domain, launch, replicated
    from mpm_flip98a_tpu_torch.state import to_device

    t_all = time.perf_counter()
    say(f"[ranks] every rank on {dev} (one card), torch.distributed backend {RANK_BACKEND} "
        f"(RankMesh stages the exchanged blocks through host memory); nccl needs a card per "
        f"rank  [{card}]")

    def single(p, scene, n):
        out = stabilized.run(to_device(p, dev), scene, n)
        torch.cuda.synchronize()
        return {f: getattr(out, f).cpu().numpy() for f in RANK_FIELDS}

    def dspec(p, scene, n):
        return domain.DomainSpec.for_particles(scene.cfg, n, p, headroom=2.0)

    def djob(tag, p, scene, n, spec, **kw):
        return dict(kind="domain", tag=tag, scene=scene, spec=spec, n=n, start=host_fields(p),
                    **kw)

    # ---- the cases and their single-device references ----------------------
    p_ref, scene_ref = driver.SCENARIOS["dam2d"]()
    scene_stab = dataclasses.replace(scene_ref, cfg=dataclasses.replace(scene_ref.cfg, **STAB))
    cases = {"dam2d": (p_ref, scene_stab, 5)}
    p_m, scene_m = scenes.dam_break_2d(MPMConfig(**MIGRATE_THROWN))
    p_m = dataclasses.replace(p_m, v=p_m.v.clone())
    p_m.v[:, 0] = 3.0
    cases["migrate"] = (p_m, scene_m, 100)
    cases["csf"] = (*drop_scene(41, 5.0, 5e-5, (32, 16), np.float64), 200)
    cases["projection"] = (*scenes.dam_break_2d(MPMConfig(
        dtype="float64", num_grids=33, dt=1e-5, num_particles_x=24, num_particles_y=48,
        fluid_width=0.105, fluid_height=0.21, flip_blend=0.98, transfer=TransferKind.PIC,
        incompressible=True, pressure_iters=60)), 25)
    cases["obstacle"] = (*driver.SCENARIOS["dam2d_obstacle"](), 50)
    refs = {tag: single(*case) for tag, case in cases.items()}
    p_b, scene_b = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC),
                                       dtype=np.float32)
    p_s, scene_s = scenes.slab_3d(**SLAB_1M)
    refs["bench1M"] = single(p_b, scene_b, 1)
    refs["slab1M"] = single(p_s, scene_s, 1)
    ref_ms = {}
    for tag, p, scene, n in (("bench1M", p_b, scene_b, 20), ("slab1M", p_s, scene_s, 5)):
        s = to_device(p, dev)
        ref_ms[tag] = ms_runs(lambda: stabilized.run(s, scene, n), n)
        del s
        torch.cuda.empty_cache()
    p37, scene37 = scenes.dam_break_2d(MPMConfig(**FAST37))
    p37 = replicated.pad_particles(p37, 12)
    refs["replicated37"] = single(p37, scene37, 50)
    torch.cuda.empty_cache()
    say(f"[ranks] single-device references done at {time.perf_counter() - t_all:.1f} s; "
        f"one device: bench 1M {ref_ms['bench1M'][0]:.4f} ms/substep, slab 1M "
        f"{ref_ms['slab1M'][0]:.4f}  [{card}]")

    # ---- 44. main:domain on 2 ranks (and the nccl refusal beside it) ----------
    specs = {tag: dspec(p, scene, 4) for tag, (p, scene, _) in cases.items()}
    spec2 = dspec(p_ref, scene_stab, 2)
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(launch.run_ranks, rank_jobs, 2, device=dev, backend=RANK_BACKEND,
                          timeout_s=RANK_TIMEOUT_S, args=(
                              [djob("dam2d", p_ref, scene_stab, 5, spec2, rerun=True)],))
        RANKS["nccl_shared_card_raises"] = nccl_refusal(dev)
        per_rank2 = two.result()

    # ---- 44-47 on 4 ranks, one launch --------------------------------------------
    jobs = [djob(tag, p, scene, n, specs[tag], rerun=tag in ("dam2d", "migrate"))
            for tag, (p, scene, n) in cases.items()]
    profile = profile_dir is not None
    for tag, p, scene, timed in (("bench1M", p_b, scene_b, (3, 20)),
                                 ("slab1M", p_s, scene_s, (3, 5))):
        jobs.append(djob(tag, p, scene, 1, dspec(p, scene, 4), timed=timed,
                         profile=profile and tag == "bench1M"))
    jobs.append(dict(kind="replicated", tag="replicated37", scene=scene37, n=50,
                     start=host_fields(p37)))
    jobs.append(dict(kind="replicated", tag="replicated_bench1M", scene=scene_b, n=1,
                     start=host_fields(p_b), timed=(3, 20), profile=profile))
    tags = [j["tag"] for j in jobs]
    t0 = time.perf_counter()
    per_rank = launch.run_ranks(rank_jobs, 4, device=dev, backend=RANK_BACKEND,
                                timeout_s=RANK_TIMEOUT_S, args=(jobs,))
    say(f"[ranks] 4 ranks ran {tags} in {time.perf_counter() - t0:.1f} s (process start "
        f"included)  [{card}]")
    launches = {"dam2d x2": rank_summary("dam2d x2", per_rank2, 0, 5, scene_stab.cfg, card)}
    for j, job in enumerate(jobs):
        launches[job["tag"]] = rank_summary(job["tag"], per_rank, j, job["n"], job["scene"].cfg,
                                            card)
    at = {tag: j for j, tag in enumerate(tags)}

    # ---- 44. main:domain: the reference scene, the migration --------------------
    for label, pr, j, n_ranks, spec in (("dam2d x2", per_rank2, 0, 2, spec2),
                                        ("dam2d x4", per_rank, at["dam2d"], 4, specs["dam2d"])):
        perm = domain.layout(p_ref, scene_stab, spec)[1]
        errs = slot_errors(merged(pr, j), {f: refs["dam2d"][f] for f in DOMAIN_TOL}, perm)
        say(f"[main:domain {label}] the reference scene (8,450 particles, 105^2, float64) with "
            f"the stabilized switch set, 5 substeps on {n_ranks} ranks against one device slot "
            f"for slot: x {errs['x']:.3e} (bound {DOMAIN_TOL['x']}), v {errs['v']:.3e} (bound "
            f"{DOMAIN_TOL['v']})  [{card}]")
        check(all(errs[f] <= DOMAIN_TOL[f] for f in DOMAIN_TOL), f"{label}: {errs}")
        RANKS[f"{label}_errors"] = errs
    got = merged(per_rank, at["migrate"])
    spec_m = specs["migrate"]
    active = got["mass"] > 0
    before = np.bincount(domain.layout(p_m, scene_m, spec_m)[1] // spec_m.capacity,
                         minlength=4)
    after = active.reshape(4, -1).sum(1)
    mass0 = float(p_m.mass.double().sum())
    mass_err = abs(float(got["mass"][active].sum()) - mass0) / mass0
    x = got["x"][active]
    ens = np.abs(np.concatenate([x.mean(0) - refs["migrate"]["x"].mean(0),
                                 x.std(0) - refs["migrate"]["x"].std(0)])).max()
    say(f"[main:domain migrate] {p_m.n} particles thrown at 3 m/s, 37^2, dt 4e-5, 100 substeps "
        f"on 4 ranks: active per rank {before.tolist()} -> {after.tolist()}, count "
        f"{int(active.sum())} (want {p_m.n}), mass relative error {mass_err:.3e} (bound 1e-12), "
        f"ensemble mean and std of x against one device {ens:.3e} (bound {ENSEMBLE_TOL})  "
        f"[{card}]")
    check((after != before).any(), "migrate: no particle changed rank")
    check(int(active.sum()) == p_m.n, "migrate: particle count changed")
    check(mass_err <= 1e-12, "migrate: mass changed")
    check(ens <= ENSEMBLE_TOL, "migrate: ensemble differs from one device")
    RANKS["migrate"] = {"active_before": before.tolist(), "active_after": after.tolist(),
                        "mass_rel_err": mass_err, "ensemble_err": float(ens)}

    # ---- 45. main:domain at scale -----------------------------------------------
    for tag, p, scene in (("bench1M", p_b, scene_b), ("slab1M", p_s, scene_s)):
        perm = domain.layout(p, scene, dspec(p, scene, 4))[1]
        errs = slot_errors(merged(per_rank, at[tag]), {f: refs[tag][f] for f in SCALE_TOL},
                           perm, scaled=("v", "C"))
        say(f"[main:domain {tag}] {p.n} particles, float32, 1 substep on 4 ranks against one "
            f"device slot for slot: x {errs['x']:.3e} (bound {SCALE_TOL['x']}), v "
            f"{errs['v']:.3e} and C {errs['C']:.3e} of their max (bound {KERNEL_REL_TOL})  "
            f"[{card}]")
        check(all(errs[f] <= SCALE_TOL[f] for f in SCALE_TOL), f"{tag}: {errs}")
        RANKS[f"{tag}_errors"] = errs
        RANKS[f"{tag}_timing"] = rank_timing(
            tag, per_rank, at[tag], 20 if tag == "bench1M" else 5, ref_ms[tag], card,
            ("halo", "migrate"))
        if profile:
            RANKS[f"{tag}_profile"] = rank_profile(tag, per_rank, at[tag], profile_dir, card)

    # ---- 46. main:domain_ext ------------------------------------------------------
    for tag in ("csf", "projection", "obstacle"):
        p, scene, n = cases[tag]
        perm = domain.layout(p, scene, specs[tag])[1]
        tol = EXT_TOL[tag]
        errs = slot_errors(merged(per_rank, at[tag]), {f: refs[tag][f] for f in tol}, perm)
        say(f"[main:domain_ext {tag}] {p.n} particles, {scene.cfg.num_grids}^2, "
            f"{scene.cfg.dtype}, {n} substeps on 4 ranks against one device slot for slot: "
            + ", ".join(f"{f} {errs[f]:.3e} (bound {tol[f]})" for f in tol) + f"  [{card}]")
        check(all(errs[f] <= tol[f] for f in tol), f"{tag}: {errs}")
        RANKS[f"{tag}_errors"] = errs

    # ---- 47. main:replicated ------------------------------------------------------
    ident = np.arange(p37.n)
    errs = slot_errors(merged(per_rank, at["replicated37"]),
                       {f: refs["replicated37"][f] for f in REPLICATED_TOL}, ident)
    say(f"[main:replicated 37^2] {p37.n} particles (padded to a multiple of 12), float64, 50 "
        f"substeps on 4 ranks against one device: "
        + ", ".join(f"{f} {errs[f]:.3e} (bound {REPLICATED_TOL[f]})" for f in REPLICATED_TOL)
        + f"  [{card}]")
    check(all(errs[f] <= REPLICATED_TOL[f] for f in REPLICATED_TOL), f"replicated37: {errs}")
    RANKS["replicated37_errors"] = errs
    errs = slot_errors(merged(per_rank, at["replicated_bench1M"]),
                       {f: refs["bench1M"][f] for f in SCALE_TOL}, np.arange(p_b.n),
                       scaled=("v", "C"))
    say(f"[main:replicated bench1M] 1 substep on 4 ranks against one device: x "
        f"{errs['x']:.3e} (bound {SCALE_TOL['x']}), v {errs['v']:.3e} and C {errs['C']:.3e} of "
        f"their max (bound {KERNEL_REL_TOL})  [{card}]")
    check(all(errs[f] <= SCALE_TOL[f] for f in SCALE_TOL), f"replicated bench1M: {errs}")
    RANKS["replicated_bench1M_errors"] = errs
    RANKS["replicated_bench1M_timing"] = rank_timing(
        "replicated bench1M", per_rank, at["replicated_bench1M"], 20, ref_ms["bench1M"], card,
        ("psum",))
    if profile:
        RANKS["replicated_bench1M_profile"] = rank_profile(
            "replicated_bench1M", per_rank, at["replicated_bench1M"], profile_dir, card)
    RANKS["scatter_launches_per_rank"] = launches
    del per_rank, per_rank2

    # ---- 48. main:dryrun ------------------------------------------------------------
    t0 = time.perf_counter()
    dryrun_multichip(4, device=dev)
    say(f"[main:dryrun] dryrun_multichip(4) on {dev}: on 4 gloo ranks in one launch the "
        f"general domain, fast_domain (and with the projection and CSF), fast_domain3d and "
        f"the 2 x 2 rank grid; the 3D elastic drop on one device: no overflow, in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    say(f"[timing] phases 44-48 done in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"ranks": RANKS}))
    return RANKS


# ---------------------------------------------------------------------------
# The fast paths on a rank mesh, one shard per rank: fast_domain (2D),
# fast_domain3d on one axis and on the 2 x 2 rank grid, fast_replicated
# ---------------------------------------------------------------------------

# Phases 49-52 run every rank on cuda:0 under gloo, as phases 44-48.  Rank 0
# also runs the references (the same shards on SlabMesh, one device) in its
# own process while the other ranks wait at a barrier, so the timed runs
# interleave on the one card.
FAST_RANK_TIMEOUT_S = 300.0
# After one substep, slot for slot against SlabMesh: the sharded gates (x
# absolute; v and C of their max; J absolute).
SHARD_GATES = {"x": 1e-6, "v": KERNEL_REL_TOL, "C": KERNEL_REL_TOL, "J": 1e-6}
ENSEMBLE_GATE = 5e-4         # float64 mean and std of x over the live slots
FAST_RANKS = {}              # the {"fast_ranks": ...} line
BENCH_RANK_STEPS = 100       # bench 1M on 4 ranks: 1 + 99 substeps
SLAB_RANK_STEPS = 20         # slab 8M on 4 and on 2 x 2 ranks: 1 + 19
REPLICATED_RANK_STEPS = 20   # fast_replicated at bench 1M
CLI3D_STEPS = 20             # dam3d on 2 x 2 ranks: 2 frames, checkpoint after the first
# dam2d_incompressible on 4 ranks: 2 frames of this many substeps.  Its CG
# takes 0.7-1.3 s a substep there (3 collectives an iteration through host
# memory; 2 x 100 substeps took 166.5 s and 2 x 20, beside the other CLIs,
# 52.6 s on an H100 80GB HBM3, 700 W).
CLI_INCOMP_STEPS = 10


def _groups(dim):
    return {"x": [f"x{a}" for a in range(dim)], "v": [f"v{a}" for a in range(dim)],
            "C": [f"C{a}{c}" for a in range(dim) for c in range(dim)], "J": ["J"]}


def gather_blocks(mesh, b, names):
    """Rank 0: each field of `names` with every rank's block concatenated
    in rank order (SlabMesh's shard-major layout), on rank 0's device; the
    other ranks send theirs and get None (`dist.gather` through host
    memory)."""
    import torch.distributed as dist

    out = {}
    for name in names:
        t = getattr(b, name).detach().to("cpu").contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.n)] if mesh.rank == 0 else None
        dist.gather(t, parts, dst=0)
        if parts is not None:
            out[name] = torch.cat(parts).to(mesh.device)
    return out if mesh.rank == 0 else None


def gate_errors(got, ref, dim) -> dict:
    """Gathered rank blocks against a SlabMesh state, slot for slot: x and
    J absolute, v and C over their max |ref|; the live slots equal; every
    gathered field bitwise equal."""
    out = {}
    for g, names in _groups(dim).items():
        a = torch.stack([got[n] for n in names]).double()
        w = torch.stack([getattr(ref, n) for n in names]).double()
        e = float((a - w).abs().max())
        out[g] = e / max(float(w.abs().max()), 1e-30) if g in ("v", "C") else e
    out["mask_equal"] = torch.equal(got["mask"], ref.mask)
    out["bitwise"] = all(torch.equal(got[n], getattr(ref, n)) for n in got)
    if not out["bitwise"]:
        out["first_differing"] = next(n for n in got if not torch.equal(got[n], getattr(ref, n)))
    return out


def ensemble_sums(b, dim, mesh=None) -> np.ndarray:
    """(count, mean and std of x per axis) of the live slots in float64;
    over every rank with `mesh` (one psum of the sums)."""
    on = b.mask > 0
    xs = torch.stack([getattr(b, f"x{a}")[on].double() for a in range(dim)], 1)
    s = torch.cat([on.sum().double().reshape(1), xs.sum(0), (xs * xs).sum(0)])
    if mesh is not None:
        s = mesh.psum(s, tag="stats")
    s = s.cpu().numpy()
    mean = s[1:1 + dim] / s[0]
    return np.concatenate([[s[0]], mean, np.sqrt(np.maximum(s[1 + dim:] / s[0] - mean ** 2, 0))])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def interleaved(mesh, run_ranks, refs, reps, n_sub):
    """`reps` x `n_sub` substeps of the ranks (`run_ranks(n)`, every rank
    at once after a barrier; ms per substep on each rank and its traffic),
    each followed on rank 0 by each reference of `refs` (name ->
    `f(n)`), the other ranks waiting at a barrier.  Warms each up first."""
    dev = mesh.device
    run_ranks(2)
    for f in refs.values():
        f(2)
    out = {"ms_runs": [], "traffic_runs": [], "ref_runs": {k: [] for k in refs}}
    for _ in range(reps):
        _sync(dev)
        mesh.barrier()
        mesh.traffic.clear()
        t0 = time.perf_counter()
        run_ranks(n_sub)
        _sync(dev)
        out["ms_runs"].append(1e3 * (time.perf_counter() - t0) / n_sub)
        out["traffic_runs"].append(_traffic(mesh))
        mesh.barrier()
        for k, f in refs.items():
            _sync(dev)
            t0 = time.perf_counter()
            f(n_sub)
            _sync(dev)
            out["ref_runs"][k].append(1e3 * (time.perf_counter() - t0) / n_sub)
        mesh.barrier()
    return out


def _timed_ms(dev, fn, reps=10, warm=2):
    """ms per call of fn on `dev` (CUDA events on a card)."""
    if dev.type == "cuda":
        return cuda_ms(fn, reps=reps, warm=warm)
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def g2p_scale(want, grid, dx, dinv):
    """compare_g2p's per-channel scale: the outputs' max, C by one term's
    size dinv dx |v|max."""
    vmax = grid.movedim(-2, 0)[:2].reshape(2, -1).abs().amax(dim=1).double()
    return torch.cat([want[:, :4].abs().amax(dim=(0, 2)).double(),
                      (dinv * dx * vmax).repeat_interleave(2),
                      want[:, 8:].abs().amax(dim=(0, 2)).double()])


def origin_kernels2d(mesh, b, scene, spec):
    """`p2g_grid` (raw, one shard) and the prepadded `g2p` on this rank's
    window, its origin s L rows from the grid's, against their plain
    versions on the same inputs (every channel over its scale), two
    reruns bitwise equal; then rank 1 alone times kernel and plain."""
    from mpm_flip98a_tpu_torch.models import fast2d
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.parallel import fast_domain as fd

    dev, cfg = mesh.device, scene.cfg
    ctx = fd.FastDomainCtx(mesh, spec.rows_per_shard)
    data, pdata2, counts = fast2d.transfer_inputs(b, scene, ctx)
    kw = dict(fused=fast2d.uses_fused(scene), shards=1, raw=True, **fast2d.p2g_args(scene))
    p2g = lambda: tk.p2g_grid(data, counts, **kw)
    raw = p2g()
    err_p, rel_p = scaled_errors(raw, tk.p2g_grid_plain(data, counts, **kw), axis=2)
    rerun_p = all(torch.equal(raw, p2g()) for _ in range(2))
    grid = fast2d._grid_update2d(ctx.halo_sync(raw.clone()), scene, ctx.row_index0(dev), None,
                                 ctx)
    dx, dinv = float(cfg.dx), float(4.0 * cfg.inv_dx * cfg.inv_dx)
    g2p = lambda: tk.g2p(pdata2, counts, grid, dx, dinv, prepadded=True)
    out = g2p()
    want = tk.g2p_plain(pdata2, counts, grid, dx, dinv, prepadded=True)
    err_g, rel_g = scaled_errors(out, want, axis=1, scale=g2p_scale(want, grid, dx, dinv))
    rerun_g = all(torch.equal(out, g2p()) for _ in range(2))
    nch, g, live = raw.shape[2], raw.shape[3], int(counts.sum())
    rec = {"origin_row": int(ctx.bucket_row0(dev)[0, 0]), "rows": int(data.shape[0]),
           "live": live,
           "p2g_grid": {"max_abs_err": max(err_p), "rel": max(rel_p), "rerun_equal": rerun_p,
                        "bound": p2g_grid_bound(data, counts, 1, nch, g)},
           "g2p": {"max_abs_err": max(err_g), "rel": max(rel_g), "rerun_equal": rerun_g,
                   "bound": bound(4 * (3 * live + counts.numel() + grid.numel() + out.numel()),
                                  live * 9 * grid.shape[2] * 2)}}
    mesh.barrier()
    if mesh.rank == 1:
        for name, call, plain in (
                ("p2g_grid", p2g, lambda: tk.p2g_grid_plain(data, counts, **kw)),
                ("g2p", g2p, lambda: tk.g2p_plain(pdata2, counts, grid, dx, dinv,
                                                  prepadded=True))):
            rec[name]["ms"] = _timed_ms(dev, call)
            rec[name]["plain_ms"] = _timed_ms(dev, plain, reps=2, warm=1)
    mesh.barrier()
    return rec


def origin_kernels3d(mesh, b, scene, spec):
    """Raw `p2g3d_grid` (one shard) and `g2p3d` (update mode) on this
    rank's window, positions less its origin, against their plain versions
    (every channel over its scale); both kernels' reruns bitwise equal
    (fixed-order gathers); rank 1 alone times kernel and plain."""
    from mpm_flip98a_tpu_torch.models import fast3d
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

    dev, cfg = mesh.device, scene.cfg
    ctx = fd3.context(spec, mesh)
    lspec = spec.stacked(mesh.blocks)
    x0s, x1s = fast3d._shifts(b, cfg, ctx)
    planes, counts, mask, state = fast3d.transfer_inputs(
        b, lspec, cfg, b.x0 - x0s, None if x1s is None else b.x1 - x1s)
    kw = fast3d.p2g_args(scene, raw=True)
    g2, dx = kw.pop("g2"), kw.pop("dx")
    p2g = lambda: tk3.p2g3d_grid(planes, counts, lspec.rows1, g2, dx, raw=True, shards=1, **kw)
    plain_p2g = lambda: tk3.p2g3d_raw_plain(planes, counts, g2, dx, shards=1, **kw)
    raw = p2g()
    err_p, rel_p = scaled_errors(raw, plain_p2g(), axis=3)
    nch, raw_numel = raw.shape[3], raw.numel()
    rerun_p = all(torch.equal(raw, p2g()) for _ in range(2))
    del raw
    grid = fast3d._sharded_grid(planes, counts, scene, lspec, False, ctx)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    g2p_in = (*planes[:3], mask, counts, grid, dx, dinv, state, float(cfg.flip_blend),
              float(cfg.dt))
    g2p = lambda: tk3.g2p3d(*g2p_in)
    out = g2p()
    want = tk3.g2p3d_plain(*g2p_in)
    scale = want.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = dinv * dx * float(grid[..., :3, :].abs().max())
    scale[15] = max(float(scale[15]), 1.0)
    err_g, rel_g = scaled_errors(out, want, axis=2, scale=scale)
    del want
    rerun_g = all(torch.equal(out, g2p()) for _ in range(2))
    slots, live, nout = mask.numel(), int(counts.sum()), out.shape[2]
    del out
    rec = {"origin": [float(x0s[0, 0]), 0.0 if x1s is None else float(x1s[0, 0])],
           "pencils": int(counts.numel()), "live": live,
           "p2g3d_grid": {"max_abs_err": max(err_p), "rel": max(rel_p), "rerun_equal": rerun_p,
                          "bound": bound(4 * (len(planes) * live + counts.numel() + raw_numel),
                                         live * 27 * nch * 2)},
           "g2p3d": {"max_abs_err": max(err_g), "rel": max(rel_g), "rerun_equal": rerun_g,
                     "bound": bound(4 * (11 * live + 3 * (slots - live) + counts.numel()
                                         + grid.numel() + nout * slots),
                                    live * 27 * (nout - 1) * 2)}}
    mesh.barrier()
    if mesh.rank == 1:
        for name, call, plain in (("p2g3d_grid", p2g, plain_p2g),
                                  ("g2p3d", g2p, lambda: tk3.g2p3d_plain(*g2p_in))):
            rec[name]["ms"] = _timed_ms(dev, call)
            rec[name]["plain_ms"] = _timed_ms(dev, plain, reps=2, warm=1)
    mesh.barrier()
    return rec


def profile_fast_rank(mesh, run_n, n_sub, logdir):
    """Rank 0 under `utils.timing.profiler_trace` (a Chrome trace into
    `logdir`) for `n_sub` substeps while the other ranks run them
    unprofiled: (device busy ms per substep, wall ms per substep, the
    table by device time); None on the other ranks."""
    from mpm_flip98a_tpu_torch.utils.timing import profiler_trace

    _sync(mesh.device)
    mesh.barrier()
    if mesh.rank:
        run_n(n_sub)
        _sync(mesh.device)
        return None
    with profiler_trace(logdir, device=mesh.device) as prof:
        t0 = time.perf_counter()
        run_n(n_sub)
        _sync(mesh.device)
        wall = 1e3 * (time.perf_counter() - t0) / n_sub
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if str(e.device_type).endswith("CUDA")) / 1e3 / n_sub
    return busy, wall, events.table(sort_by="cuda_time_total", row_limit=30)


def trace_dir(job) -> str:
    """Where rank 0 writes a job's Chrome trace under the profile dir."""
    return os.path.join(job["profile"], "trace_fast_" + job["tag"].replace(" ", "_"))


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _fresh(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def rank_bench2d(mesh, job):
    """bench 1M on the ranks (`fast_domain`) against SlabMesh(n) on rank
    0: the layout, 1 substep and 100 slot for slot, the launches, 3 x 20
    timed interleaved with SlabMesh and one device, the kernels on this
    rank's window."""
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.parallel import SlabMesh
    from mpm_flip98a_tpu_torch.parallel import fast_domain as fd

    dev, lead = mesh.device, mesh.rank == 0
    _fresh(dev)
    p, scene = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC),
                                   dtype=np.float32)
    cfg = scene.cfg
    spec = fd.FastDomainSpec.for_particles(cfg, mesh.n, p, headroom=2.0)
    b = fd.distribute(p, cfg, spec, mesh)
    run = fd.make_run(scene, spec, mesh)
    rec = {"particles": p.n, "rows_per_shard": spec.rows_per_shard, "block": list(b.shape)}
    if lead:
        slab = SlabMesh(mesh.n, dev)
        ref, ref_run = fd.distribute(p, cfg, spec, slab), fd.make_run(scene, spec, slab)
        one_spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
        one = [fast2d.from_particles(p, cfg, one_spec, dev)]
    del p
    names = [f.name for f in dataclasses.fields(b)]
    got = gather_blocks(mesh, b, names)
    if lead:
        rec["layout_bitwise"] = all(torch.equal(got[n], getattr(ref, n)) for n in names)
    del got
    # The references run on rank 0 after the ranks' counts are read: the
    # launch counters are per process.
    reset_counts()
    stats = fast2d.RunStats()
    b = run(b, 1, stats)
    _sync(dev)
    got1 = gather_blocks(mesh, b, names)
    b = run(b, BENCH_RANK_STEPS - 1, stats)
    _sync(dev)
    rec.update(launches=kernel_counts(), substeps=stats.substeps, rebuckets=stats.rebuckets,
               overflow=int(b.overflow.sum()), traffic=_traffic(mesh), num_grids=cfg.num_grids)
    ens = ensemble_sums(b, 2, mesh)
    got = gather_blocks(mesh, b, names)
    if lead:
        ref = ref_run(ref, 1)
        rec["after1"] = gate_errors(got1, ref, 2)
        ref = ref_run(ref, BENCH_RANK_STEPS - 1)
        rec["after100"] = gate_errors(got, ref, 2)
        rec["ensemble"] = (ens, ensemble_sums(ref, 2))
    del got, got1
    state = [b]

    def ranks_n(k):
        state[0] = run(state[0], k)

    refs = {}
    if lead:
        hold = [ref]

        def slab_n(k):
            hold[0] = ref_run(hold[0], k)

        def one_n(k):
            one[0] = fast2d.run(one[0], scene, one_spec, k)

        refs = {"slab_mesh": slab_n, "one_device": one_n}
    rec["timing"] = interleaved(mesh, ranks_n, refs, 3, 20)
    refs.clear()
    if job.get("profile"):
        rec["profile"] = profile_fast_rank(mesh, ranks_n, 5, trace_dir(job))
    rec["kernels"] = origin_kernels2d(mesh, state[0], scene, spec)
    rec["peak_bytes"] = _peak(dev)
    return rec


def rank_slab3d(mesh, job):
    """slab 8M (job["stab"]: the stabilized set) on the ranks, one axis
    or job["grid"] = (n0, n1), against SlabMesh of that shape on rank 0: 1
    substep by the shard gates, job["n"] by the ensemble gate, the
    launches, 3 x 10 timed interleaved with SlabMesh, with job["kernels"]
    the kernels on this rank's window."""
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.parallel import RankMesh, SlabMesh
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

    grid = job.get("grid")
    m = mesh if grid is None else RankMesh(mesh.device, mesh.backend, grid=grid)
    dev, lead = m.device, m.rank == 0
    _fresh(dev)
    p, scene = scenes.slab_3d(**SLAB_8M)
    if job.get("stab"):
        scene = dataclasses.replace(scene, cfg=dataclasses.replace(scene.cfg, **STAB))
    cfg = scene.cfg
    spec = fd3.FastDomain3DSpec.for_particles(cfg, (m.n0, m.n1), p)
    b = fd3.distribute(p, cfg, spec, m)
    run = fd3.make_run(scene, spec, m)
    rec = {"particles": p.n, "windows": [spec.rows_per_shard0, spec.rows_per_shard1],
           "block": list(b.shape)}
    if lead:
        slab = SlabMesh(m.n0, dev, m.n1)
        ref, ref_run = fd3.distribute(p, cfg, spec, slab), fd3.make_run(scene, spec, slab)
    del p
    names = [n for ns in _groups(3).values() for n in ns] + ["mask"]
    reset_counts()
    stats = fast2d.RunStats()
    b = run(b, 1, stats)
    _sync(dev)
    got = gather_blocks(m, b, names)
    n = job["n"]
    if n > 1:
        b = run(b, n - 1, stats)
        _sync(dev)
    rec.update(launches=kernel_counts(), substeps=stats.substeps, rebuckets=stats.rebuckets,
               overflow=int(b.overflow.sum()), traffic=_traffic(m), num_grids=cfg.num_grids)
    ens = ensemble_sums(b, 3, m)
    if lead:      # after the counts: rank 0's references launch kernels too
        ref = ref_run(ref, 1)
        rec["after1"] = gate_errors(got, ref, 3)
        del got
        if n > 1:
            ref = ref_run(ref, n - 1)
        rec["ensemble"] = (ens, ensemble_sums(ref, 3))
    else:
        del got
    if job.get("timed"):
        state = [b]

        def ranks_n(k):
            state[0] = run(state[0], k)

        refs = {}
        if lead:
            hold = [ref]

            def slab_n(k):
                hold[0] = ref_run(hold[0], k)

            refs = {"slab_mesh": slab_n}
        rec["timing"] = interleaved(m, ranks_n, refs, *job["timed"])
        refs.clear()
        b = state[0]
    if lead:
        del ref
    if job.get("profile"):
        rec["profile"] = profile_fast_rank(m, ranks_n, 5, trace_dir(job))
    if job.get("kernels"):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec["kernels"] = origin_kernels3d(m, b, scene, spec)
    rec["peak_bytes"] = _peak(dev)
    return rec


def rank_replicated(mesh, job):
    """fast_replicated at bench 1M (job["stab"]: the stabilized set, the
    prepped branch) on the ranks against one device on rank 0: the
    ensemble after job["n"] substeps, the overflow, one all_reduce of the
    folded grid a substep, the launches; with job["timed"] that many
    substeps timed interleaved with one device."""
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.parallel import fast_replicated as fr

    dev, lead = mesh.device, mesh.rank == 0
    _fresh(dev)
    p, scene = scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC,
                                             **(STAB if job.get("stab") else {})),
                                   dtype=np.float32)
    cfg = scene.cfg
    b, spec = fr.distribute(p, cfg, mesh)
    run = fr.make_run(scene, spec, mesh)
    rec = {"particles": p.n, "block": list(b.shape)}
    if lead:
        one_spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
        one = [fast2d.from_particles(p, cfg, one_spec, dev)]
    del p
    reset_counts()
    mesh.traffic.clear()
    stats = fast2d.RunStats()
    n = job["n"]
    b = run(b, n, stats)
    _sync(dev)
    rec.update(launches=kernel_counts(), substeps=stats.substeps, rebuckets=stats.rebuckets,
               overflow=int(b.overflow.sum()), traffic=_traffic(mesh), num_grids=cfg.num_grids)
    ens = ensemble_sums(b, 2, mesh)
    if lead:
        one[0] = fast2d.run(one[0], scene, one_spec, n)
        rec["ensemble"] = (ens, ensemble_sums(one[0], 2))
    state = [b]

    def ranks_n(k):
        state[0] = run(state[0], k)

    refs = {}
    if lead:
        def one_n(k):
            one[0] = fast2d.run(one[0], scene, one_spec, k)

        refs = {"one_device": one_n}
    if job.get("timed"):
        rec["timing"] = interleaved(mesh, ranks_n, refs, *job["timed"])
    refs.clear()
    rec["peak_bytes"] = _peak(dev)
    return rec


def fast_rank_jobs(mesh, jobs):
    """The rank worker of phases 49-51 (one process a rank, started by
    `launch.run_ranks`; it prints nothing): each job of `jobs` by its
    kind, its record of host data with its seconds on this rank."""
    kinds = {"bench2d": rank_bench2d, "slab3d": rank_slab3d, "replicated": rank_replicated}
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        rec = kinds[job["kind"]](mesh, job)
        rec["seconds"] = time.perf_counter() - t0
        out.append(rec)
    return out


def _per_rank(per_rank, j):
    return [r[j] for r in per_rank]


def report_gates(tag, rec, what, card, gated=True):
    """Prints the slot-for-slot errors against SlabMesh; with `gated`
    checks the shard gates and the live slots."""
    e = rec[what]
    line = (f"x {e['x']:.3e} (bound {SHARD_GATES['x']}), v {e['v']:.3e} and C {e['C']:.3e} of "
            f"their max (bound {KERNEL_REL_TOL}), J {e['J']:.3e} (bound {SHARD_GATES['J']}), "
            f"live slots equal {e['mask_equal']}, every field bitwise equal {e['bitwise']}"
            + (f" (first differing field {e['first_differing']})" if not e["bitwise"] else ""))
    say(f"[main:fast_ranks {tag}] {what} against SlabMesh slot for slot: {line}"
        + ("" if gated else " (reported; the ensemble gate holds it)") + f"  [{card}]")
    if gated:
        check(e["mask_equal"], f"{tag} {what}: the live slots differ from SlabMesh's")
        check(all(e[g] <= tol for g, tol in SHARD_GATES.items()),
              f"{tag} {what}: outside the shard gates: {e}")
    return e


def report_ensemble(tag, rec, n_particles, card, against):
    got, want = (np.asarray(a) for a in rec["ensemble"])
    diff = float(np.abs(got[1:] - want[1:]).max())
    say(f"[main:fast_ranks {tag}] after {rec['substeps']} substeps: live slots {int(got[0])} "
        f"(want {n_particles}), ensemble mean and std of x against {against} {diff:.3e} "
        f"(bound {ENSEMBLE_GATE}), overflow per rank {rec['overflow_per_rank']} (bound 0), "
        f"rebuckets per rank {rec['rebuckets_per_rank']}  [{card}]")
    check(int(got[0]) == n_particles, f"{tag}: {int(got[0])} live slots")
    check(diff <= ENSEMBLE_GATE, f"{tag}: the ensemble left {against}'s")
    check(not any(rec["overflow_per_rank"]), f"{tag}: overflow {rec['overflow_per_rank']}")
    return diff


def report_launches(tag, recs, want, card):
    """Each rank's launches in its main run: each kernel of `want`
    (name -> count) exactly, every other transfer kernel 0."""
    per = [r["launches"] for r in recs]
    say(f"[main:fast_ranks {tag}] launches per rank {per} (want {want}, the others 0)  [{card}]")
    for r, got in enumerate(per):
        for name, count in got.items():
            check(count == want.get(name, 0),
                  f"{tag}: rank {r} launched {name} {count} times, want {want.get(name, 0)}")
    return {name: [got[name] for got in per] for name in want}


def report_timing(tag, recs, n_sub, card, exchange_tags):
    """ms per substep (median of the slowest rank's runs) against each
    reference rank 0 ran in turn; each rank's exchange ms, bytes and calls
    per substep; peak memory per rank."""
    runs = [max(r["timing"]["ms_runs"][k] for r in recs)
            for k in range(len(recs[0]["timing"]["ms_runs"]))]
    refs = recs[0]["timing"]["ref_runs"]
    per = lambda r, i: sum(r["timing"]["traffic_runs"][0].get(t, [0, 0, 0.0])[i]
                           for t in exchange_tags)
    ex_ms = [float(np.median([sum(tr.get(t, [0, 0, 0.0])[2] for t in exchange_tags)
                              for tr in r["timing"]["traffic_runs"]])) * 1e3 / n_sub
             for r in recs]
    out = {"ms": float(np.median(runs)), "runs": runs,
           **{f"{k}_ms": float(np.median(v)) for k, v in refs.items()},
           **{f"{k}_runs": v for k, v in refs.items()},
           "exchange_ms_per_rank": ex_ms,
           "exchange_bytes_per_rank": [per(r, 1) / n_sub for r in recs],
           "exchange_calls_per_rank": [per(r, 0) / n_sub for r in recs],
           "peak_bytes_per_rank": [r["peak_bytes"] for r in recs]}
    say(f"[timing:fast_ranks {tag}] {len(recs)} ranks on one card under gloo: {out['ms']:.4f} "
        f"ms/substep (median of {len(runs)} x {n_sub}, the slowest rank's; runs "
        f"{[round(x, 4) for x in runs]}); in turn on rank 0: "
        + "; ".join(f"{k} {out[k + '_ms']:.4f} (runs {[round(x, 4) for x in v]})"
                    for k, v in refs.items())
        + f"; exchanges ({'+'.join(exchange_tags)}) per rank per substep "
        f"{[round(x, 4) for x in ex_ms]} ms, {out['exchange_bytes_per_rank']} bytes in "
        f"{out['exchange_calls_per_rank']} calls; peak device memory per rank "
        f"{out['peak_bytes_per_rank']} bytes  [{card}]")
    return out


def report_origin(tag, recs, names, card, err, kernel_ms, plain_ms, bounds):
    """The kernels on each rank's window against plain (every rank),
    rank 1's times; kept under "<name>_ranks" for the kernels line."""
    for name in names:
        rels = [r["kernels"][name]["rel"] for r in recs]
        reruns = [r["kernels"][name].get("rerun_equal") for r in recs]
        one = recs[1]["kernels"][name]
        key = f"{name}_ranks"
        err[key] = max(r["kernels"][name]["max_abs_err"] for r in recs)
        kernel_ms[key], plain_ms[key], bounds[key] = one["ms"], one["plain_ms"], one["bound"]
        where = recs[1]["kernels"].get("origin_row", recs[1]["kernels"].get("origin"))
        say(f"[kernels:fast_ranks {tag}] {name} on each rank's own window (rank 1's origin "
            f"{where}) against its plain version: worst channel over its scale per rank "
            f"{['%.2e' % x for x in rels]} (tol {KERNEL_REL_TOL}), max_abs_err {err[key]:.3e}, "
            f"reruns bitwise equal per rank {reruns}; rank 1 alone: {one['ms']:.4f} ms (CUDA "
            f"events, 10 calls), plain {one['plain_ms']:.4f} ms, bound {one['bound'][0]:.4f} ms "
            f"({one['bound'][1]})  [{card}]")
        check(max(rels) <= KERNEL_REL_TOL, f"{tag}: {name} on a rank's window disagrees with "
              f"its plain version: {rels}")
        check(all(x is not False for x in reruns), f"{tag}: {name} reruns differ on a rank")
        if name == "p2g3d_grid":
            RERUNS["p2g3d_grid_rank_window"] = RERUNS.get("p2g3d_grid_rank_window", True) and \
                all(reruns)


def fast_rank_clis(dev, card):
    """Phase 51, main:fast_ranks_cli: the CLIs with --ranks --backend gloo
    (dam2d_flip98 on 4 ranks, 2 frames x 100 substeps, dam2d_incompressible
    2 x CLI_INCOMP_STEPS; dam3d on 2 x 2 ranks with a checkpoint, resumed
    on ranks and on SlabMesh(2, 2) against the uninterrupted SlabMesh run),
    and the nccl refusal through the CLI."""
    from mpm_flip98a_tpu_torch import driver
    from mpm_flip98a_tpu_torch.parallel import launch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    out = {}
    try:
        def cli(name, scenario, devices, frames, n_sub, *extra):
            argv = ["--scenario", scenario, "--path", "fast", "--devices", devices, "--ranks",
                    "--backend", "gloo", "--frames", str(frames), "--substeps", str(n_sub),
                    "--no-gif", "--out", os.path.join(tmp, name), "--device", str(dev),
                    *extra]
            t0 = time.perf_counter()
            got = driver.main(argv)
            return argv, got, time.perf_counter() - t0

        def refusal():
            try:
                driver.main(["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "2",
                             "--ranks", "--backend", "nccl", "--frames", "1", "--substeps", "1",
                             "--no-gif", "--out", os.path.join(tmp, "nccl"),
                             "--device", str(dev)])
            except launch.RankError as e:
                return str(e)
            return None

        ck1, ck2 = os.path.join(tmp, "ck1"), os.path.join(tmp, "ck2")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            runs = {
                "dam2d_flip98": pool.submit(cli, "2d", "dam2d_flip98", "4", 2, 100),
                "dam2d_incompressible": pool.submit(cli, "inc", "dam2d_incompressible", "4", 2,
                                                    CLI_INCOMP_STEPS),
                "dam3d 2x2": pool.submit(cli, "3d", "dam3d", "2x2", 1, CLI3D_STEPS,
                                         "--checkpoint", ck1),
            }
            nccl = pool.submit(refusal)
            runs = {k: f.result() for k, f in runs.items()}
            nccl = nccl.result()
        resumed = cli("3dr", "dam3d", "2x2", 1, CLI3D_STEPS, "--resume", ck1, "--checkpoint",
                      ck2)
        say(f"[main:fast_ranks_cli] three CLIs and the nccl refusal at once, then the resume, "
            f"in {time.perf_counter() - t0:.1f} s (process starts included)  [{card}]")
        for name, (argv, got, seconds) in list(runs.items()) + [("dam3d 2x2 resumed", resumed)]:
            frames = sorted(os.listdir(got[0]["frame_dir"]))
            say(f"[main:fast_ranks_cli {name}] {' '.join(argv)} in {seconds:.1f} s: per rank "
                f"frame count {[r['frame_count'] for r in got]}, substeps "
                f"{[r['substeps'] for r in got]}, rebuckets {[r['rebuckets'] for r in got]}, "
                f"overflow {[r['overflow'] for r in got]}, frames written "
                f"{[r['frames_written'] for r in got]}; rank 0's frame dir {frames}  [{card}]")
            n_frames = int(argv[argv.index("--frames") + 1])
            check(all(r["overflow"] == 0 for r in got), f"{name}: overflow")
            check([r["frames_written"] for r in got] == [n_frames] + [0] * (len(got) - 1),
                  f"{name}: frames not written by rank 0 alone")
            check(len([f for f in frames if f.endswith(".png")]) == n_frames,
                  f"{name}: {frames}")
            out[name] = {"seconds": seconds, "frames": frames,
                         "substeps_per_rank": [r["substeps"] for r in got]}
        check(resumed[1][0]["frame_count"] == 2, "dam3d resumed on ranks: frame count")
        ok = nccl is not None and "share one card" in nccl and "backend='gloo'" in nccl
        say(f"[main:fast_ranks_cli] --ranks --backend nccl with 2 ranks on this card raises: "
            f"{ok} ({nccl.strip().splitlines()[-1] if nccl else 'no error'})  [{card}]")
        check(ok, "the CLI's nccl ranks on one card did not raise")
        out["nccl_shared_card_raises"] = ok
        # The resumed runs against the uninterrupted one, all on SlabMesh(2, 2)
        # in this process: ck2 (ranks resumed ck1), SlabMesh resuming ck1.
        p, scene = driver.SCENARIOS["dam3d"]()
        make = lambda: driver.Simulation(p, scene, path="fast", devices=(2, 2), device=dev,
                                         out_dir=os.path.join(tmp, "slab"))
        whole = make()
        whole.run(2, CLI3D_STEPS, gif=False, verbose=False, write_frames=False)
        on_slab = make()
        on_slab.restore_checkpoint(ck1)
        on_slab.run(1, CLI3D_STEPS, gif=False, verbose=False, write_frames=False)
        from_ranks = make()
        from_ranks.restore_checkpoint(ck2)
        groups = (("x", ("x0", "x1", "x2")), ("v", ("v0", "v1", "v2")), ("J", ("J",)))
        for label, sim in (("resumed on ranks", from_ranks), ("resumed on SlabMesh", on_slab)):
            worst = {key: max(float((getattr(sim.state, n).double()
                                     - getattr(whole.state, n).double()).abs().max())
                              for n in names) for key, names in groups}
            equal = all(torch.equal(getattr(sim.state, f.name), getattr(whole.state, f.name))
                        for f in dataclasses.fields(whole.state))
            say(f"[main:fast_ranks_cli dam3d 2x2] {label} (frame {sim.frame_count}) against "
                f"the uninterrupted SlabMesh(2, 2) run: every field bitwise equal {equal}, "
                f"x, v, J max |diff| {worst}  [{card}]")
            check(sim.frame_count == 2, f"dam3d {label}: frame count {sim.frame_count}")
            check(equal, f"dam3d {label}: differs from the uninterrupted run: {worst}")
            out[f"dam3d {label}"] = {**worst, "bitwise_equal": equal}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fast_ranks_phases(dev, card, profile_dir, err, kernel_ms, plain_ms, bounds, launches):
    """Phases 49-51: the fast paths one shard per rank (4 gloo ranks on
    this card, one launch for every case: bench 1M, slab 8M on 4 and on 2
    x 2 ranks, stab3d-8M, fast_replicated), each against SlabMesh of its
    shape or one device run by rank 0; the kernels on a rank's window;
    then the --ranks CLIs."""
    from mpm_flip98a_tpu_torch.parallel import launch

    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    prof = {} if profile_dir is None else {"profile": os.path.abspath(profile_dir)}
    jobs = [
        dict(kind="bench2d", tag="bench1M", **prof),
        dict(kind="slab3d", tag="slab8M", n=SLAB_RANK_STEPS, timed=(3, 10), kernels=True, **prof),
        dict(kind="slab3d", tag="slab8M 2x2", grid=(2, 2), n=SLAB_RANK_STEPS, timed=(3, 10),
             **prof),
        dict(kind="slab3d", tag="stab3d-8M", stab=True, n=1),
        dict(kind="replicated", tag="replicated bench1M", n=REPLICATED_RANK_STEPS,
             timed=(3, 10)),
        dict(kind="replicated", tag="replicated stab1M", stab=True, n=5),
    ]
    per_rank = launch.run_ranks(fast_rank_jobs, 4, device=dev, backend=RANK_BACKEND,
                                timeout_s=FAST_RANK_TIMEOUT_S, args=(jobs,))
    say(f"[fast_ranks] 4 ranks ran {[j['tag'] for j in jobs]} in "
        f"{time.perf_counter() - t_all:.1f} s (process start included); seconds per job on "
        f"rank 0 {[round(r['seconds'], 1) for r in per_rank[0]]}  [{card}]")
    for j, job in enumerate(jobs):
        recs = _per_rank(per_rank, j)
        recs[0]["overflow_per_rank"] = [r["overflow"] for r in recs]
        recs[0]["rebuckets_per_rank"] = [r["rebuckets"] for r in recs]
    # ---- 49. main:fast_ranks bench 1M --------------------------------------------
    recs = _per_rank(per_rank, 0)
    r0 = recs[0]
    say(f"[main:fast_ranks bench1M] {r0['particles']} particles, {r0['num_grids']}^2, 4 ranks of "
        f"{r0['rows_per_shard']} rows, blocks {r0['block']}: each rank's rows of the global "
        f"layout bitwise SlabMesh(4)'s: {r0['layout_bitwise']}  [{card}]")
    check(r0["layout_bitwise"], "bench1M: the ranks' layout differs from SlabMesh's")
    FAST_RANKS["bench1M_after1"] = report_gates("bench1M", r0, "after1", card)
    FAST_RANKS["bench1M_after100"] = report_gates("bench1M", r0, "after100", card, gated=False)
    FAST_RANKS["bench1M_ensemble"] = report_ensemble("bench1M", r0, r0["particles"], card,
                                                     "SlabMesh(4)")
    launches["p2g_grid ranks"] = report_launches(
        "bench1M", recs, {"p2g_grid": BENCH_RANK_STEPS, "g2p": BENCH_RANK_STEPS}, card)["p2g_grid"]
    launches["g2p ranks"] = [r["launches"]["g2p"] for r in recs]
    FAST_RANKS["bench1M_timing"] = report_timing("bench1M", recs, 20, card, ("halo", "migrate"))
    if profile_dir:
        FAST_RANKS["bench1M_profile"] = rank_profile("fast_bench1M", per_rank, 0, profile_dir,
                                                     card)
    report_origin("bench1M", recs, ("p2g_grid", "g2p"), card, err, kernel_ms, plain_ms, bounds)
    # ---- 50. main:fast_ranks slab 8M, 2 x 2, stab3d-8M ----------------------------
    for j, tag in ((1, "slab8M"), (2, "slab8M 2x2"), (3, "stab3d-8M")):
        recs = _per_rank(per_rank, j)
        r0 = recs[0]
        say(f"[main:fast_ranks {tag}] {r0['particles']} particles, {r0['num_grids']}^3, windows "
            f"{r0['windows']}, blocks {r0['block']}  [{card}]")
        FAST_RANKS[f"{tag}_after1"] = report_gates(tag, r0, "after1", card)
        want = {"p2g3d_grid": r0["substeps"], "g2p3d": r0["substeps"]}
        got = report_launches(tag, recs, want, card)
        launches[f"p2g3d_grid ranks {tag}"] = got["p2g3d_grid"]
        launches[f"g2p3d ranks {tag}"] = got["g2p3d"]
        if r0["substeps"] > 1:
            FAST_RANKS[f"{tag}_ensemble"] = report_ensemble(
                tag, r0, r0["particles"], card, "SlabMesh")
        if "timing" in r0:
            FAST_RANKS[f"{tag}_timing"] = report_timing(tag, recs, jobs[j]["timed"][1], card,
                                                        ("halo", "migrate"))
        if profile_dir and "profile" in r0:
            FAST_RANKS[f"{tag}_profile"] = rank_profile(f"fast_{tag.replace(' ', '_')}",
                                                        per_rank, j, profile_dir, card)
        if "kernels" in r0:
            report_origin(tag, recs, ("p2g3d_grid", "g2p3d"), card, err, kernel_ms, plain_ms,
                          bounds)
    # ---- 50. main:fast_ranks fast_replicated (fused and prepped) ------------------
    for j, tag, ran in ((4, "replicated bench1M", "p2g_fused"), (5, "replicated stab1M", "p2g")):
        recs = _per_rank(per_rank, j)
        r0 = recs[0]
        n = r0["substeps"]
        got = report_launches(tag, recs, {ran: n, "g2p": n}, card)
        launches[f"{ran} {tag} ranks"] = got[ran]
        launches[f"g2p {tag} ranks"] = got["g2p"]
        FAST_RANKS[f"{tag}_ensemble"] = report_ensemble(tag, r0, r0["particles"], card,
                                                        "one device")
        psum = [r["traffic"]["grid_psum"] for r in recs]
        say(f"[main:fast_ranks {tag}] the folded grid's all_reduce per rank: "
            f"{[c for c, _, _ in psum]} calls in {n} substeps (want {n}), "
            f"{[b / max(c, 1) for c, b, _ in psum]} bytes and "
            f"{[round(1e3 * s / max(c, 1), 4) for c, _, s in psum]} ms a call  [{card}]")
        check(all(c == n for c, _, _ in psum), f"{tag}: not one all_reduce a substep")
        FAST_RANKS[f"{tag}_psum"] = {"calls": [c for c, _, _ in psum],
                                     "bytes_per_call": [b / max(c, 1) for c, b, _ in psum],
                                     "ms_per_call": [1e3 * s / max(c, 1) for c, _, s in psum]}
        if "timing" in r0:
            FAST_RANKS[f"{tag}_timing"] = report_timing(tag, recs, jobs[j]["timed"][1], card,
                                                        ("grid_psum",))
    del per_rank
    say(f"[timing] main:fast_ranks done in {time.perf_counter() - t_all:.1f} s")
    # ---- 51. main:fast_ranks_cli ---------------------------------------------------
    t0 = time.perf_counter()
    FAST_RANKS["cli"] = fast_rank_clis(dev, card)
    say(f"[timing] main:fast_ranks_cli done in {time.perf_counter() - t0:.1f} s; phases 49-51 "
        f"{time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"fast_ranks": FAST_RANKS}))
    return FAST_RANKS


def fast_ranks_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches):
    """The kernels of phases 49-50 on the ranks: each rank's launches in
    its main run under "ranks_launches*" and the kernels on a rank's own
    window (rank 1: a nonzero origin) under "ranks_*"."""
    by_name = {k["name"]: k for k in kernels}
    by_name["p2g_grid"]["ranks_launches"] = launches["p2g_grid ranks"]
    by_name["g2p"]["ranks_launches"] = launches["g2p ranks"]
    by_name["g2p"]["replicated_ranks_launches"] = launches["g2p replicated bench1M ranks"]
    by_name["g2p"]["replicated_stab1M_ranks_launches"] = launches["g2p replicated stab1M ranks"]
    by_name["p2g_fused"]["replicated_ranks_launches"] = launches[
        "p2g_fused replicated bench1M ranks"]
    by_name["p2g"]["replicated_stab1M_ranks_launches"] = launches["p2g replicated stab1M ranks"]
    for tag, key in (("slab8M", "ranks_launches"), ("slab8M 2x2", "ranks_2x2_launches"),
                     ("stab3d-8M", "ranks_stab3d_launches")):
        by_name["p2g3d_grid"][key] = launches[f"p2g3d_grid ranks {tag}"]
        by_name["g2p3d"][key] = launches[f"g2p3d ranks {tag}"]
    for name in ("p2g_grid", "g2p", "p2g3d_grid", "g2p3d"):
        key = f"{name}_ranks"
        by_name[name].update({
            "ranks_max_abs_err": err[key], "ranks_ms": kernel_ms[key],
            "ranks_plain_ms": plain_ms[key], "ranks_bound_ms": bounds[key][0],
            "ranks_bound_by": bounds[key][1]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of the 2D bench, stab1M, drop1M, "
                    "the 8M slab and stab3d-8M, single-device and sharded, "
                    "obstacle8M and the fused 2D routes here")
    args = ap.parse_args(argv)

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mpm_flip98a_tpu_torch import _build, driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

    check("jax" not in sys.modules, "jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)} capability {torch.cuda.get_device_capability(0)}")
    t_start = time.perf_counter()
    reset_all, counts_now = reset_counts, kernel_counts

    # ---- 2. build ---------------------------------------------------------
    build = _build.load()
    say(f"[build] {'cached' if build.cached else 'nvcc'} {build.seconds:.2f} s -> "
        f"{os.path.relpath(build.path, root)} from "
        f"{[os.path.relpath(s, root) for s in _build.sources()]} "
        f"flags {' '.join(_build.NVCC_FLAGS)}")
    for line in build.log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "smem", "spill", "== ")):
            say(f"[build] {line.strip()}")

    # ---- 3. kernels:2d ----------------------------------------------------
    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC)
    t0 = time.perf_counter()
    p_big, scene_big = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec_big = fast2d.FastSpec.for_particles(cfg, p_big)
    b = fast2d.from_particles(p_big, cfg, spec_big, dev)
    b = fast2d.run(b, scene_big, spec_big, 20)
    torch.cuda.synchronize()
    say(f"[kernels:2d] bench state: {p_big.n} particles, grid {cfg.num_grids}^2, "
        f"buckets {tuple(b.shape)}, 20 substeps in {time.perf_counter() - t0:.2f} s")
    sdata, pdata2, counts = fast2d.transfer_inputs(b, scene_big)
    p_args = fast2d.p2g_args(scene_big)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    grid_bench = fast2d._grid_update2d(
        tk.fold_rows(tk.p2g_fused(sdata, counts, **p_args)), scene_big
    )
    err = {}
    err["p2g_fused"], err["g2p"] = compare_kernels(
        "bench", sdata, pdata2, counts, grid_bench, p_args, dinv, card
    )
    rs, rp, rc, rgrid, rg = ragged_inputs(dev)
    compare_kernels("ragged", rs, rp, rc, rgrid, {**p_args, "g": rg}, dinv, card)
    args_at = {**p_args, "g": rg, "apic": True, "eos": "tait"}
    compare_kernels("ragged apic tait", rs, rp, rc, rgrid, args_at, dinv, card)
    rerun_equal("kernels:2d bench", "p2g_fused", lambda: tk.p2g_fused(sdata, counts, **p_args),
                card)
    rerun_equal("kernels:2d ragged apic tait", "p2g_fused",
                lambda: tk.p2g_fused(rs, rc, **args_at), card)
    kernel_ms = {
        "p2g_fused": cuda_ms(lambda: tk.p2g_fused(sdata, counts, **p_args)),
        "g2p": cuda_ms(lambda: tk.g2p(pdata2, counts, grid_bench, p_args["dx"], dinv)),
    }
    plain_ms = {
        "p2g_fused": cuda_ms(lambda: tk.p2g_fused_plain(sdata, counts, **p_args)),
        "g2p": cuda_ms(lambda: tk.g2p_plain(pdata2, counts, grid_bench, p_args["dx"], dinv)),
    }
    r2, _, k2 = sdata.shape
    live2 = int(counts.sum())
    g2d = cfg.num_grids
    bounds = {
        # live slots' 11 fields + counts in; (R, 5, 5, G) out; 9 taps x 5
        # channels of multiply-adds per live slot.
        "p2g_fused": bound(4 * (11 * live2 + r2 + r2 * 25 * g2d), live2 * 9 * 5 * 2),
        # live slots' [gx0, gx1, mask] + counts + the grid in; every slot's
        # 8 channels out; 9 taps x 8 sums of multiply-adds per live slot.
        "g2p": bound(4 * (3 * live2 + r2 + r2 * 4 * g2d + r2 * 8 * k2), live2 * 9 * 8 * 2),
    }
    for name in ("p2g_fused", "g2p"):
        say(f"[kernels:2d] {name} at bench shapes: kernel {kernel_ms[name]:.4f} ms, "
            f"plain {plain_ms[name]:.4f} ms (CUDA events, 20 calls), bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")
    ACHIEVED["p2g_fused"] = achieved("p2g_fused at bench 1M",
                                     4 * (11 * live2 + r2 + r2 * 25 * g2d),
                                     kernel_ms["p2g_fused"], card)
    del b, sdata, pdata2, counts, grid_bench, rs, rp, rc, rgrid

    # ---- 4. main:2d ---------------------------------------------------------
    io_ok = frame_io_available()
    if not io_ok:
        say("[main] frame IO unavailable (no native writer, no PIL): "
            "running with frame output off")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    launches = {}
    try:
        n_frames, n_sub = 2, 200
        argv_cli = [
            "--scenario", "dam2d_flip98", "--path", "fast", "--frames", str(n_frames),
            "--substeps", str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda",
        ]
        p_ref, _ = driver.SCENARIOS["dam2d_flip98"]()
        mass_ref = float(p_ref.mass.to(torch.float32).double().sum())
        reset_all()
        if io_ok:
            sim = driver.main(argv_cli)
        else:
            p, scene = driver.SCENARIOS["dam2d_flip98"]()
            sim = driver.Simulation(p, scene, path="fast", out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        got = counts_now()
        say(f"[main:dam2d_flip98] {'CLI ' + ' '.join(argv_cli) if io_ok else 'Simulation'}: "
            f"launches {got}, substeps {sim.stats.substeps}")
        for name in ("p2g_fused", "g2p"):
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{name} launched {got[name]} times for {n_frames * n_sub} substeps")
            launches[name] = got[name]
        check(got["p2g"] == got["p2g_grid"] == got["p2g3d_grid"] == got["g2p3d"] == 0,
              "p2g, p2g_grid or a 3D kernel ran on the fused 2D path")
        host_checks("dam2d_flip98", sim, p_ref.n, mass_ref, card)
        if io_ok:
            frames = sorted(os.listdir(sim.frame_dir)), sorted(os.listdir(sim.vtk_dir))
            say(f"[main:dam2d_flip98] frames {frames}")
            check(len(frames[0]) == len(frames[1]) == n_frames, "frame files missing")

        mass_big = float(p_big.mass.to(torch.float32).double().sum())
        sim_big = driver.Simulation(p_big, scene_big, path="fast", out_dir=out_dir, device=dev)
        reset_all()
        t0 = time.perf_counter()
        sim_big.run(2, 100, gif=False, verbose=False, write_frames=io_ok)
        torch.cuda.synchronize()
        launches_big = counts_now()
        say(f"[main:bench] Simulation 2 frames x 100 substeps in "
            f"{time.perf_counter() - t0:.2f} s, launches {launches_big}, "
            f"capacity {sim_big.spec.capacity}")
        say("[main:bench] timers\n" + sim_big.timers.summary())
        for name in ("p2g_fused", "g2p"):
            check(launches_big[name] == 200, f"bench: {name} launched {launches_big[name]} times")
        check(launches_big["p2g"] == 0, "bench: p2g ran on the fused path")
        host_checks("bench", sim_big, p_big.n, mass_big, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 5. timing:2d -------------------------------------------------------
    b, spec = sim_big.state, sim_big.spec
    step2d = lambda s: fast2d.substep(s, scene_big)
    wall2d = time_paths("2d", fast2d, b, scene_big, spec, step2d, p_big.n,
                        cfg.stencil_size, 100, 3, card)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profile_window(os.path.join(args.profile, "profile_bench_20_substeps.txt"),
                       fast2d, b, scene_big, spec, 20, 1e3 * wall2d, "2d", card)
    del sim_big, b, p_big
    torch.cuda.empty_cache()
    say(f"[timing] 2D phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 6. kernels:2dp -----------------------------------------------------
    # The prepped-P2G branch at the bench scale: stab1M is the stabilized
    # switch set on the bench dam break, drop1M elastic_drop_2d with the
    # same config (a 244^2 neo-Hookean block in the 1M-particle column).
    cfg_stab = MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC)
    builds = {
        "stab1M": scenes.dam_break_2d(cfg_stab, dtype=np.float32),
        "drop1M": scenes.elastic_drop_2d(cfg_stab, dtype=np.float32),
    }
    states = {}
    for tag, (p, scene) in builds.items():
        t0 = time.perf_counter()
        spec = fast2d.FastSpec.for_particles(cfg_stab, p)
        states[tag] = fast2d.run(fast2d.from_particles(p, cfg_stab, spec, dev), scene, spec, 20)
        torch.cuda.synchronize()
        check(not fast2d.uses_fused(scene), f"{tag} took the fused branch")
        say(f"[kernels:2dp] {tag}: {p.n} particles, materials {scene.materials_present}, "
            f"buckets {tuple(states[tag].shape)}, 20 substeps in {time.perf_counter() - t0:.2f} s")
    p_stab, scene_stab = builds["stab1M"]
    pdata, pdata2, counts = fast2d.transfer_inputs(states["stab1M"], scene_stab)
    args_p = fast2d.p2g_args(scene_stab)
    grid7 = fast2d._grid_update2d(tk.fold_rows(tk.p2g(pdata, counts, **args_p)), scene_stab)
    err["p2g"], err["g2p_ext"] = compare_prepped(
        "stab1M", pdata, pdata2, counts, grid7, args_p, dinv, card)
    # drop1M's state through the same scene without F-bar and mixing: the
    # 6-channel prepped rows of a two-material scene.
    p_drop, scene_drop = builds["drop1M"]
    scene6 = dataclasses.replace(scene_drop, cfg=dataclasses.replace(
        cfg_stab, use_fbar=False, pressure_mixing_ratio=0.0))
    d6, d2, dc = fast2d.transfer_inputs(states["drop1M"], scene6)
    args6 = fast2d.p2g_args(scene6)
    grid4 = fast2d._grid_update2d(tk.fold_rows(tk.p2g(d6, dc, **args6)), scene6)
    compare_prepped("drop1M", d6, d2, dc, grid4, args6, dinv, card)
    del d6, d2, dc, grid4
    rp, rp2, rc, rgrid, rg = ragged_prepped(dev)
    rargs = dict(g=rg, dx=0.4375 / (rg - 5), tent=True, apic=False)
    _, err["g2p_tent"] = compare_prepped("ragged tent", rp, rp2, rc, rgrid, rargs, 1.0, card)
    del rp, rp2, rc, rgrid

    dx2 = args_p["dx"]
    kernel_ms["p2g"] = cuda_ms(lambda: tk.p2g(pdata, counts, **args_p))
    plain_ms["p2g"] = cuda_ms(lambda: tk.p2g_plain(pdata, counts, **args_p), reps=5, warm=1)
    kernel_ms["g2p_ext"] = cuda_ms(lambda: tk.g2p(pdata2, counts, grid7, dx2, dinv))
    plain_ms["g2p_ext"] = cuda_ms(
        lambda: tk.g2p_plain(pdata2, counts, grid7, dx2, dinv), reps=5, warm=1)
    r2, nrows, k2 = pdata.shape
    nch = nrows - 8
    live2 = int(counts.sum())
    p2g_bytes = 4 * ((8 + nch) * live2 + r2 + 5 * nch * r2 * g2d)
    bounds["p2g"] = bound(
        # live slots' 8 + nch rows + counts in; (R, 5, nch, G) out; 9 taps x
        # nch channels of multiply-adds per live slot.
        p2g_bytes, live2 * 9 * nch * 2)
    bounds["g2p_ext"] = bound(
        # live slots' [gx0, gx1, mask] + counts + the 7-channel grid in;
        # every slot's 11 channels out; 9 taps x 11 sums per live slot.
        4 * (3 * live2 + r2 + 7 * r2 * g2d + 11 * r2 * k2), live2 * 9 * 11 * 2)
    for name, label in (("p2g", f"p2g ({nch} channels)"), ("g2p_ext", "g2p (7-channel grid)")):
        say(f"[kernels:2dp] {label} at stab1M shapes (buckets {r2}x{k2}, {live2} live): kernel "
            f"{kernel_ms[name]:.4f} ms (CUDA events, 20 calls), plain {plain_ms[name]:.4f} ms "
            f"(5 calls), bound {bounds[name][0]:.4f} ms ({bounds[name][1]})  [{card}]")
    # The tent modes at the same shapes: stab1M's rows with hat taps (no
    # ported scene runs the tent kernel at this scale).
    args_t = {**args_p, "tent": True}
    kernel_ms["p2g_tent"] = cuda_ms(lambda: tk.p2g(pdata, counts, **args_t))
    kernel_ms["g2p_tent"] = cuda_ms(lambda: tk.g2p(pdata2, counts, grid7, dx2, 1.0, True))
    say(f"[kernels:2dp] tent taps at stab1M shapes: p2g {kernel_ms['p2g_tent']:.4f} ms, "
        f"g2p (7-channel grid) {kernel_ms['g2p_tent']:.4f} ms (CUDA events, 20 calls)  [{card}]")
    achieved("p2g at stab1M", p2g_bytes, kernel_ms["p2g"], card)
    rerun_equal("kernels:2dp stab1M", "p2g", lambda: tk.p2g(pdata, counts, **args_p), card)
    rerun_equal("kernels:2dp stab1M tent", "p2g", lambda: tk.p2g(pdata, counts, **args_t), card)
    pd_d, _, cnt_d = fast2d.transfer_inputs(states["drop1M"], scene_drop)
    args_d = fast2d.p2g_args(scene_drop)
    live_d = int(cnt_d.sum())
    bytes_d = 4 * (pd_d.shape[1] * live_d + r2 + 5 * nch * r2 * g2d)
    bound_d = bound(bytes_d, live_d * 9 * nch * 2)
    kernel_ms["p2g_drop1M"] = cuda_ms(lambda: tk.p2g(pd_d, cnt_d, **args_d))
    say(f"[kernels:2dp] p2g at drop1M shapes (pdata {tuple(pd_d.shape)}, "
        f"{pd_d.numel() * 4} bytes, {live_d} live): kernel {kernel_ms['p2g_drop1M']:.4f} ms, "
        f"bound {bound_d[0]:.4f} ms ({bound_d[1]})  [{card}]")
    achieved("p2g at drop1M", bytes_d, kernel_ms["p2g_drop1M"], card)
    rerun_equal("kernels:2dp drop1M", "p2g", lambda: tk.p2g(pd_d, cnt_d, **args_d), card)
    del pdata, pdata2, counts, grid7, pd_d, cnt_d, states

    # ---- 7. main:elastic_drop -------------------------------------------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        n_frames, n_sub = 2, 200
        argv_cli = [
            "--scenario", "elastic_drop", "--path", "fast", "--frames", str(n_frames),
            "--substeps", str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda",
        ]
        p_ref, _ = driver.SCENARIOS["elastic_drop"]()
        mass_ref = float(p_ref.mass.to(torch.float32).double().sum())
        reset_all()
        t0 = time.perf_counter()
        if io_ok:
            sim = driver.main(argv_cli)
        else:
            p, scene = driver.SCENARIOS["elastic_drop"]()
            sim = driver.Simulation(p, scene, path="fast", out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        got = counts_now()
        say(f"[main:elastic_drop] {'CLI ' + ' '.join(argv_cli) if io_ok else 'Simulation'} in "
            f"{time.perf_counter() - t0:.2f} s: launches {got}, substeps {sim.stats.substeps}, "
            f"buckets {tuple(sim.state.shape)}")
        for name in ("p2g", "g2p"):
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{name} launched {got[name]} times for {n_frames * n_sub} substeps")
        launches["p2g"] = got["p2g"]
        check(got["p2g_fused"] == got["p2g3d_grid"] == got["g2p3d"] == 0,
              "p2g_fused or a 3D kernel ran on the prepped 2D path")
        host_checks("elastic_drop", sim, p_ref.n, mass_ref, card)
        if io_ok:
            frames = sorted(os.listdir(sim.frame_dir)), sorted(os.listdir(sim.vtk_dir))
            check(len(frames[0]) == len(frames[1]) == n_frames, "frame files missing")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del sim

    # ---- 8. main:stab1M, main:drop1M ----------------------------------------
    sims = {}
    for tag, (p, scene) in builds.items():
        mass0 = float(p.mass.to(torch.float32).double().sum())
        sim = driver.Simulation(p, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev)
        reset_all()
        t0 = time.perf_counter()
        sim.run(2, 100, gif=False, verbose=False, write_frames=False)
        torch.cuda.synchronize()
        got = counts_now()
        say(f"[main:{tag}] Simulation 2 frames x 100 substeps in {time.perf_counter() - t0:.2f} s, "
            f"launches {got}, buckets {tuple(sim.state.shape)}")
        for name in ("p2g", "g2p"):
            check(got[name] == 200, f"{tag}: {name} launched {got[name]} times")
        check(got["p2g_fused"] == 0, f"{tag}: p2g_fused ran on the prepped path")
        host_checks(tag, sim, p.n, mass0, card)
        if tag == "stab1M":
            jh = fast2d.to_host(sim.state)["J"]
            say(f"[main:stab1M] J range [{float(jh.min())!r}, {float(jh.max())!r}] "
                f"(bound |J - 1| < 0.1)")
            check(float(np.abs(jh - 1.0).max()) < 0.1, "stab1M: J left [0.9, 1.1]")
        sims[tag] = sim

    # ---- 9. timing:2dp --------------------------------------------------------
    for tag, sim in sims.items():
        scene, n_part = sim.scene, builds[tag][0].n
        step = lambda s, scene=scene: fast2d.substep(s, scene)
        wall = time_paths(tag, fast2d, sim.state, scene, sim.spec, step, n_part,
                          cfg_stab.stencil_size, 100, 3, card)
        if args.profile:
            profile_window(os.path.join(args.profile, f"profile_{tag}_20_substeps.txt"),
                           fast2d, sim.state, scene, sim.spec, 20, 1e3 * wall, tag, card)
    del sims, sim, builds, p_stab, p_drop
    torch.cuda.empty_cache()
    say(f"[timing] 2D prepped phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 10. main:dam3d ------------------------------------------------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        n_frames, n_sub = 2, 100
        argv_cli = [
            "--scenario", "dam3d", "--path", "fast", "--frames", str(n_frames),
            "--substeps", str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda",
        ]
        p_ref, _ = driver.SCENARIOS["dam3d"]()
        mass_ref = float(p_ref.mass.to(torch.float32).double().sum())
        reset_all()
        t0 = time.perf_counter()
        if io_ok:
            sim = driver.main(argv_cli)
        else:
            p, scene = driver.SCENARIOS["dam3d"]()
            sim = driver.Simulation(p, scene, path="fast", out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        got = counts_now()
        say(f"[main:dam3d] {'CLI ' + ' '.join(argv_cli) if io_ok else 'Simulation'} in "
            f"{time.perf_counter() - t0:.2f} s: launches {got}, substeps {sim.stats.substeps}, "
            f"buckets {tuple(sim.state.shape)}")
        for name in ("p2g3d_grid", "g2p3d"):
            check(got[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{name} launched {got[name]} times for {n_frames * n_sub} substeps")
            launches[name] = got[name]
        check(got["p2g_fused"] == got["p2g"] == got["g2p"] == 0, "a 2D kernel ran on the 3D path")
        host_checks("dam3d", sim, p_ref.n, mass_ref, card)
        if io_ok:
            frames = sorted(os.listdir(sim.frame_dir)), sorted(os.listdir(sim.vtk_dir))
            say(f"[main:dam3d] frames {frames}")
            check(len(frames[0]) == len(frames[1]) == n_frames, "frame files missing")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del sim

    # ---- 11. main:slab8M -----------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p8, scene8 = scenes.slab_3d(**SLAB_8M)
    mass8 = float(p8.mass.to(torch.float32).double().sum())
    sim8 = driver.Simulation(p8, scene8, path="fast", out_dir=tempfile.gettempdir(), device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    reset_all()
    t0 = time.perf_counter()
    sim8.run(2, 25, gif=False, verbose=False, write_frames=False)
    torch.cuda.synchronize()
    got = counts_now()
    say(f"[main:slab8M] {p8.n} particles, grid {scene8.cfg.num_grids}^3, buckets "
        f"{tuple(sim8.state.shape)} (capacity {sim8.spec.capacity}); built in {t_build:.2f} s; "
        f"Simulation 2 frames x 25 substeps in {time.perf_counter() - t0:.2f} s, "
        f"launches {got}  [{card}]")
    say("[main:slab8M] timers\n" + sim8.timers.summary())
    for name in ("p2g3d_grid", "g2p3d"):
        check(got[name] == 50, f"slab8M: {name} launched {got[name]} times")
    host_checks("slab8M", sim8, p8.n, mass8, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b8 = fast3d.rebucket(sim8.state, scene8.cfg, sim8.spec)
    torch.cuda.synchronize()
    t_reb = time.perf_counter() - t0
    check(int(b8.overflow) == 0, "slab8M: forced rebucket overflowed")
    peak = torch.cuda.max_memory_allocated()
    say(f"[main:slab8M] one forced rebucket {1e3 * t_reb:.2f} ms; peak device memory "
        f"(state build, 50 substeps, rebucket) {peak} bytes = {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated; {PEAK_BEFORE_GIB['slab8M']} GiB with the "
        f"atomic-scatter p2g3d_grid and its raw buffer)  [{card}]")
    del b8

    # ---- 12. kernels:3d --------------------------------------------------------
    b = sim8.state
    cfg8, spec8 = scene8.cfg, sim8.spec
    planes, counts, mask, state = fast3d.transfer_inputs(b, spec8, cfg8)
    kw3 = {**fast3d.p2g_args(scene8), "alpha": float(cfg8.flip_blend)}
    dinv3 = float(4.0 * cfg8.inv_dx * cfg8.inv_dx)
    err["p2g3d_grid"], err["g2p3d"], grid8 = compare_kernels3d(
        "slab8M", planes, counts, mask, state, kw3, dinv3, card
    )
    rplanes, rmask, rcounts, rstate, rg, rdx = ragged_inputs3d(dev)
    rkw = {**kw3, "g2": rg, "dx": rdx, "hi": rg - 3, "fa": -kw3["dt"] * 4.0 / rdx**2}
    compare_kernels3d("ragged3d", rplanes, rcounts, rmask, rstate, rkw, 4.0 / rdx**2, card)
    del rplanes, rmask, rcounts, rstate

    args8 = {n: v for n, v in kw3.items() if n != "alpha"}
    g2p_in = (*planes[:3], mask, counts, grid8, kw3["dx"], dinv3, state, kw3["alpha"], kw3["dt"])
    kernel_ms["p2g3d_grid"] = cuda_ms(lambda: tk3.p2g3d_grid(planes, counts, spec8.rows1, **args8))
    kernel_ms["g2p3d"] = cuda_ms(lambda: tk3.g2p3d(*g2p_in))
    plain_ms["p2g3d_grid"] = cuda_ms(
        lambda: tk3.p2g3d_grid_plain(planes, counts, spec8.rows1, **args8), reps=3, warm=1)
    plain_ms["g2p3d"] = cuda_ms(lambda: tk3.g2p3d_plain(*g2p_in), reps=3, warm=1)
    r0, r1, k3 = mask.shape
    g3 = kw3["g2"]
    live3 = int(counts.sum())
    nodes = (r0 + 4) * (r1 + 4) * g3
    bounds["p2g3d_grid"] = bound(
        # live slots' 18 planes + counts in; the finished 6-channel grid out;
        # 27 taps x 7 channels of multiply-adds per live slot.
        4 * (18 * live3 + r0 * r1 + 6 * nodes), live3 * 27 * 7 * 2)
    bounds["g2p3d"] = bound(
        # live slots' 11 planes, dead slots' x (3) + counts + the grid in;
        # every slot's 16 channels out; 27 taps x 15 sums per live slot.
        4 * (11 * live3 + 3 * (r0 * r1 * k3 - live3) + r0 * r1 + 6 * nodes
             + 16 * r0 * r1 * k3), live3 * 27 * 15 * 2)
    for name in ("p2g3d_grid", "g2p3d"):
        say(f"[kernels:3d] {name} at the 8M shapes (buckets {r0}x{r1}x{k3}, {live3} live): "
            f"kernel {kernel_ms[name]:.4f} ms (CUDA events, 20 calls), plain "
            f"{plain_ms[name]:.4f} ms (3 calls), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{card}]")
    plan_line("kernels:3d", "stress", tk3.P2G_CH, g3, r0, r1, card,
              apic=bool(args8["apic"]))
    del planes, state, mask, counts, grid8, g2p_in

    # ---- 13. timing:3d ---------------------------------------------------------
    step8 = lambda s: fast3d.substep(s, scene8, spec8)
    wall8 = time_paths("3d 8M/256^3", fast3d, b, scene8, spec8, step8, p8.n, 27, 20, 3,
                       card, plain=False)
    if args.profile:
        profile_window(os.path.join(args.profile, "profile_slab8M_5_substeps.txt"),
                       fast3d, b, scene8, spec8, 5, 1e3 * wall8, "3d 8M/256^3", card)
    del sim8, b
    torch.cuda.empty_cache()
    p1, scene1 = scenes.slab_3d(**SLAB_1M)
    spec1 = fast3d.FastSpec3D.for_particles(scene1.cfg, p1)
    b1 = fast3d.from_particles(p1, scene1.cfg, spec1, dev)
    step1 = lambda s: fast3d.substep(s, scene1, spec1)
    say(f"[timing:3d 1M/128^3] slab_3d(): {p1.n} particles, buckets {tuple(b1.shape)}")
    time_paths("3d 1M/128^3", fast3d, b1, scene1, spec1, step1, p1.n, 27, 20, 3, card)
    del b1, p1
    torch.cuda.empty_cache()
    say(f"[timing] 3D fused phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 14-18. the 3D prepped branch --------------------------------------------
    prepped3d_phases(dev, card, args.profile, p8, scene8, err, kernel_ms, plain_ms, bounds,
                     launches, t_start)
    del p8
    torch.cuda.empty_cache()
    say(f"[timing] 3D prepped phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 19-22. the slab-sharded path in 2D (--devices N) --------------------------
    timing = sharded2d_phases(dev, card, args, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] 2D sharded phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 23-25. the one-axis slab-sharded path in 3D --------------------------------
    sharded3d_phases(dev, card, args.profile, err, kernel_ms, plain_ms, bounds, launches,
                     timing)
    say(f"[timing] 3D sharded phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 26-29. rigid SDF colliders ------------------------------------------------
    flips = collider_phases(dev, card, io_ok, args.profile, err, kernel_ms, plain_ms, bounds,
                            launches)
    say(f"[timing] collider phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 30-34. the general path and the validation model --------------------------
    general_phases(dev, card, io_ok, args.profile)
    say(f"[timing] general phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 35. plasticity: snow, sand, the corotated clamp ---------------------------
    plastic_phases(dev, card, io_ok, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] plastic phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 36. CSF surface tension and the incompressible projection -----------------
    incompressible_phases(dev, card, io_ok, args.profile, err, kernel_ms, plain_ms, bounds,
                          launches)
    say(f"[timing] incompressible phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 37-40. the fixed-order scatter, checkpoints, the two-axis mesh, halo1 --
    port_phases(dev, card, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] port13 phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 41-43. the fully fused 2D substep, p2g3d's stress mode ------------------
    fused2d_phases(dev, card, io_ok, args.profile, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] fused2d phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 44-48. the general path's slab domain and replicated grid on ranks --
    ranks_phases(dev, card, args.profile)
    say(f"[timing] general ranks phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 49-51. the fast paths one shard per rank, the --ranks CLIs -----------
    fast_ranks_phases(dev, card, args.profile, err, kernel_ms, plain_ms, bounds, launches)
    say(f"[timing] all phases done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": kernel_ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # No single PyTorch call computes a B-spline P2G or G2P.
         "library_ms": None}
        for name, (src, tpu) in TPU_KERNELS.items()
    ]
    # g2p's 7-channel mode beside its base (4-channel) numbers, and the tent
    # mode's error on the ragged case.
    next(k for k in kernels if k["name"] == "g2p").update({
        "ext_max_abs_err": err["g2p_ext"], "ext_ms": kernel_ms["g2p_ext"],
        "ext_plain_ms": plain_ms["g2p_ext"], "ext_bound_ms": bounds["g2p_ext"][0],
        "ext_bound_by": bounds["g2p_ext"][1], "tent_max_abs_err": err["g2p_tent"],
        "tent_ms": kernel_ms["g2p_tent"],
    })
    # p2g and p2g3d sum in a fixed order: reruns at every timed shape are
    # bitwise equal (checked above), and p2g's time at drop1M.
    next(k for k in kernels if k["name"] == "p2g").update({
        "tent_ms": kernel_ms["p2g_tent"], "drop1M_ms": kernel_ms["p2g_drop1M"],
        "rerun_bitwise_equal": RERUNS["p2g"]})
    # g2p on the sharded path's prepadded grid (bench 1M in 4 shards; the
    # 7-channel grid at stab1M), launched once per substep there.
    next(k for k in kernels if k["name"] == "g2p").update({
        "prepadded_launches": launches["g2p prepadded"],
        "prepadded_max_abs_err": err["g2p_prepadded"], "prepadded_ms": kernel_ms["g2p_prepadded"],
        "prepadded_plain_ms": plain_ms["g2p_prepadded"],
        "prepadded_bound_ms": bounds["g2p_prepadded"][0],
        "prepadded_bound_by": bounds["g2p_prepadded"][1],
        "prepadded_ext_max_abs_err": err["g2p_prepadded_ext"],
        "prepadded_ext_ms": kernel_ms["g2p_prepadded_ext"],
    })
    # p2g_grid's prepped 9-channel mode at stab1M in 4 shards and its tent
    # mode on the ragged case, beside the fused mode at bench 1M.
    # p2g_fused and p2g_grid sum in a fixed order too (reruns checked above
    # at every timed shape); p2g_grid against fold_rows_halo of p2g_fused /
    # p2g per shard.
    next(k for k in kernels if k["name"] == "p2g_fused").update({
        "rerun_bitwise_equal": RERUNS["p2g_fused"],
        "achieved_bytes_per_s": ACHIEVED["p2g_fused"]})
    next(k for k in kernels if k["name"] == "p2g_grid").update({
        "rerun_bitwise_equal": RERUNS["p2g_grid"], "equal_to_fold": FOLD["equal"],
        "fold_max_abs_diff": FOLD["max_abs_diff"],
        "achieved_bytes_per_s": ACHIEVED["p2g_grid"],
        "prepped_achieved_bytes_per_s": ACHIEVED["p2g_grid_prepped"],
        "tent_achieved_bytes_per_s": ACHIEVED["p2g_grid_tent"],
        "prepped_launches": launches["p2g_grid prepped"],
        "prepped_max_abs_err": err["p2g_grid_prepped"], "prepped_ms": kernel_ms["p2g_grid_prepped"],
        "prepped_plain_ms": plain_ms["p2g_grid_prepped"],
        "prepped_bound_ms": bounds["p2g_grid_prepped"][0],
        "prepped_bound_by": bounds["p2g_grid_prepped"][1],
        "tent_max_abs_err": err["p2g_grid_tent"], "tent_ms": kernel_ms["p2g_grid_tent"],
        "tent_bound_ms": bounds["p2g_grid_tent"][0], "tent_bound_by": bounds["p2g_grid_tent"][1],
    })
    # The 3D kernels' prepped modes at the stab3d-8M shapes beside their
    # fused-branch numbers, and the tent modes' errors on the ragged case.
    by_name = {k["name"]: k for k in kernels}
    by_name["p2g3d"].update({
        "tent_max_abs_err": err["p2g3d_tent"], "tent_ms": kernel_ms["p2g3d_tent"],
        "apic7_max_abs_err": err["p2g3d_apic7"], "rerun_bitwise_equal": RERUNS["p2g3d"]})
    for name, mode, key in (("p2g3d_grid", "p2g3d_grid_prepped", "prepped"),
                            ("g2p3d", "g2p3d_gather", "gather")):
        by_name[name].update({
            f"{key}_launches": launches[f"{name} on stab3d-8M"],
            f"{key}_max_abs_err": err[mode], f"{key}_ms": kernel_ms[mode],
            f"{key}_plain_ms": plain_ms[mode], f"{key}_bound_ms": bounds[mode][0],
            f"{key}_bound_by": bounds[mode][1], "tent_max_abs_err": err[f"{name}_tent"],
            "tent_ms": kernel_ms[f"{name}_tent"],
        })
        # The modes main:drop3d launched (25 APIC planes -> 7 raw channels;
        # gather on the 6-channel grid), at drop3d's shapes.
        at_drop = f"{name}_drop3d"
        by_name[name].update({
            "drop3d_launches": launches[f"{name} on drop3d"],
            "drop3d_max_abs_err": err[at_drop], "drop3d_ms": kernel_ms[at_drop],
            "drop3d_plain_ms": plain_ms[at_drop], "drop3d_bound_ms": bounds[at_drop][0],
            "drop3d_bound_by": bounds[at_drop][1],
        })
    # p2g3d_grid's raw mode on the 3D sharded path: slab 8M (stress) and
    # stab3d-8M (prepped, 11 channels) in 4 shards.
    for mode, key in (("raw", "raw"), ("raw_prepped", "raw_prepped")):
        name = f"p2g3d_grid_{key}"
        by_name["p2g3d_grid"].update({
            f"{mode}_launches": launches[f"p2g3d_grid {key}"],
            f"{mode}_max_abs_err": err[name], f"{mode}_ms": kernel_ms[name],
            f"{mode}_plain_ms": plain_ms[name], f"{mode}_bound_ms": bounds[name][0],
            f"{mode}_bound_by": bounds[name][1],
        })
    # g2p3d on the 3D sharded path's shard windows: the update mode at slab
    # 8M and the gather mode (9-channel grid) at stab3d-8M in 4 shards.
    for mode, key in (("sharded", "raw"), ("sharded_gather", "raw_prepped")):
        name = f"g2p3d_{mode}"
        by_name["g2p3d"].update({
            f"{mode}_launches": launches[f"g2p3d {key}"],
            f"{mode}_max_abs_err": err[name], f"{mode}_ms": kernel_ms[name],
            f"{mode}_plain_ms": plain_ms[name], f"{mode}_bound_ms": bounds[name][0],
            f"{mode}_bound_by": bounds[name][1],
        })
    # p2g3d_grid's collider mode: launched on the obstacle8M run, held to
    # plain there and on the ragged cases (stress, prepped 11 channels,
    # tent), timed at the obstacle8M shapes beside the same call without
    # colliders; the nodes whose inside flag differs, summed over the cases.
    by_name["p2g3d_grid"].update({
        "colliders_launches": launches["p2g3d_grid colliders"],
        "colliders_max_abs_err": err["p2g3d_grid_colliders"],
        "colliders_ms": kernel_ms["p2g3d_grid_colliders"],
        "colliders_free_ms": kernel_ms["p2g3d_grid_colliders_free"],
        "colliders_plain_ms": plain_ms["p2g3d_grid_colliders"],
        "colliders_bound_ms": bounds["p2g3d_grid_colliders"][0],
        "colliders_bound_by": bounds["p2g3d_grid_colliders"][1],
        "colliders_flips": flips,
        # The plan at each timed shape; reruns bitwise equal, every mode
        # (each checked: a false fails the run).
        "plans": PLANS,
        "rerun_bitwise_equal": {k[len("p2g3d_grid_"):]: v for k, v in RERUNS.items()
                                if k.startswith("p2g3d_grid_")},
    })
    # The modes main:plastic launched, at its scenes' shapes: p2g and g2p on
    # snow2k and sand2k, p2g3d_grid's prepped mode and g2p3d's gather mode
    # on sanddrop3d.
    for name, tags in (("p2g", ("snow2k", "sand2k")), ("g2p", ("snow2k", "sand2k")),
                       ("p2g3d_grid", ("sanddrop3d",)), ("g2p3d", ("sanddrop3d",))):
        for tag in tags:
            key = f"{tag}_{name}"
            by_name[name].update({
                f"{tag}_launches": launches[key], f"{tag}_max_abs_err": err[key],
                f"{tag}_ms": kernel_ms[key], f"{tag}_plain_ms": plain_ms[key],
                f"{tag}_bound_ms": bounds[key][0], f"{tag}_bound_by": bounds[key][1],
            })
    # The kernels on main:incompressible's inputs: p2g_fused and g2p at
    # incomp1M, p2g_grid and the prepadded g2p at incomp1M in 4 shards, p2g3d
    # (7 channels) and g2p3d's gather mode at incomp8M, p2g3d_grid's raw mode
    # and g2p3d on the shard windows at incomp8M in 4 shards.
    for name, tags in (("p2g_fused", ("incomp1M",)), ("g2p", ("incomp1M", "incomp1Mx4")),
                       ("p2g_grid", ("incomp1Mx4",)), ("p2g3d", ("incomp8M",)),
                       ("g2p3d", ("incomp8M", "incomp8Mx4")), ("p2g3d_grid", ("incomp8Mx4",))):
        for tag in tags:
            key = f"{tag}_{name}"
            by_name[name][f"{tag}_max_abs_err"] = err[key]
            by_name[name][f"{tag}_launches"] = launches[key]
            if key in kernel_ms:
                by_name[name].update({
                    f"{tag}_ms": kernel_ms[key],
                    f"{tag}_plain_ms": plain_ms[key], f"{tag}_bound_ms": bounds[key][0],
                    f"{tag}_bound_by": bounds[key][1]})
    port_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches)
    fused2d_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches)
    # The scatter on the ranks of phases 44-47: each rank's launches in each
    # run, one a scatter of the window (checked there).
    next(k for k in kernels if k["name"] == "scatter")["ranks_launches"] = (
        RANKS["scatter_launches_per_rank"])
    fast_ranks_kernel_keys(kernels, err, kernel_ms, plain_ms, bounds, launches)
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
