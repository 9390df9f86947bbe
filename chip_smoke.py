#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calclens_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; imports neither jax nor calclens_tpu.  Phases, each
of which must pass:

  1. card: name and power limit (nvidia-smi), torch / CUDA versions; TF32
     is switched off for matmuls and cuDNN;
  2. build: the hand-written kernels (calclens_tpu_torch/csrc/*.cu) are
     compiled for sm_90a from the checkout, one nvcc per source;
  3. kernels vs twins: K1 (Legendre analysis), K2 (synthesis with
     derivatives, 16 columns) and K2's potential-only form (4 columns), K3
     (bucketed synthesis, with and without derivatives), all three with
     their per-tile turning-point cutoff, and K4 (stored-lambda analysis,
     contracted on the tensor cores) against their plain PyTorch twins on
     the card, on band-limited random inputs from a numpy seed, at orders 8
     and 10, bound max|kernel - twin| / max|twin| < 1e-5 per output column;
     K3's seed pre-pass against the twin's chain, bit for bit, with its
     share of its bound; all timed at order 10;
  4. CUDA vs CPU trace: the port's Raytracer at SHTOrder 7 / rayOrder 6,
     float32, two planes of seeded particles at pixel centres, once on
     the CPU (twins) and once on the card (kernels); the packed ray buffers
     must agree within 5e-4 of each quantity's max |value| after every
     plane.  Run with the default kernels (K2, K1) and with the variant (K3
     with its seed pre-pass, K4), both with the default synthesis ring
     stage, then with (K2, K1) and the "uniform" stage; each CUDA run must
     have launched its kernels.
     Then Raytracer.run, with MapRedshiftList and OutputPath, on the CPU
     and on the card (8 planes): the driver writes the lens maps after
     planes 1 and 2, and the card's Convergence_ and Rays_ files agree
     with the CPU's within the same bound (ray counts exact);
  5. headline: SHTOrder 12 (NSIDE 4096, lmax 12287), rayOrder 10
     (12,582,912 rays), 2^21 particles, float32, through Raytracer.step:
     one warm-up plane and two timed planes, with the kernel launch counts
     of exactly that run, the peak device memory and finite rays; one more
     plane with Profile set, whose phase row (DEPOSIT, SHTSOLVE, SHT,
     RAYPROP) is printed; one timed plane with the "uniform" synthesis ring
     stage when the default is another, its time beside the default's;
     then the variant headline (K3, K4): one warm-up plane and two timed
     planes, K3,
     its seed pre-pass and K4 launched and K1 and K2 not, and the distance
     of its rays from the default run's rays after the same planes.  After
     the default run's planes, the driver's lens maps at LensMapOrder 8:
     the card's [7, npix] sums against a float64 host accumulation of the
     same rays (counts exact, the rest within 1e-5 of each row's max), and
     the Convergence_ and Rays_ FITS files read back.  Run to run, with
     each pair of kernels: one plane's deposit twice on the same
     particles, and one plane twice from a copy of the same rays, rays and
     order-8 lens maps equal bit for bit;
  6. the kernels at the headline shape: K1 and K2 against their twins
     (same 1e-5 bound); K2's 4-column form, K3 in both forms and K4 against
     their twins on a set of m rows (all rings, all degrees; the full twins
     would take minutes); K3's seed table against the twin's chain, bit for
     bit; K4 against K1 on the same inputs; alm2map (K2, 4 columns) against
     alm2allmaps(...)[0] (K2, 16 columns), and the same with K3 (its
     potential-only form against its 12 buckets), launches counted; K3's
     distance from K2 printed (the two seed lambda_mm differently), and
     each one's distance from float64 twins on the m rows, polar caps and
     belt apart; every kernel timed with CUDA events (K3 on a seed table
     written before, its pre-pass alone) beside its bound from the shapes
     (K2's and K3's also on the full triangle; K4's the longer of its
     CUDA-core and tensor-core operations) and its issue floor; K1, K4,
     K2, K2-4col and K3 in both forms each launched twice on the same
     inputs, equal bits, and K1 and K4 on a block of m rows (m0 > 0) equal
     to the whole launch's rows bit for bit;
  7. P1, the Legendre roofline probe (csrc/roofline_probe.cu): each mode
     (rec, rec+store, store, dot) against its plain version at two shapes
     where the recurrence stays finite, one of them the timed layout (1e-6
     of max |plain|, dot 1e-5); then the tool's ceilings() at its default
     shape (6.44e9 elements), whose launches are counted, beside the plain
     versions and, for dot, torch.bmm in FP32; store and dot also held to
     their plain versions at that shape; each mode's bound, the store
     modes' from the card's shared-memory peak; each Legendre kernel's
     share of the rec and rec+store ceilings from its order-12 time of
     phase 6 and the tool's exact element counts; the SASS of the
     rec+store loop keeps its stores (a float stored per FADD); the SASS
     instructions per element of the rec loop and of the steady loops of
     K1-K4 (for K4 also without its HMMA);
  8. P2-P4, the gather probes (csrc/gather_probe.cu), through the tool's
     run() at N = 2^23: each bit-exact against torch's tab[idx], timed
     beside it with its share of its bound, launches counted; P4 bound by
     its tensor-core products,
     its SASS holding HGMMA (wgmma) and no HMMA;
  9. the synthesis ring stages (sht/rings.py, czt.py): at order 12 each
     mode (uniform, v2) on the same two streams, K2's q rows of
     band-limited alm through unfold_pairs, timed with CUDA events after
     its first call (which builds its tables, timed apart), with its peak
     memory and its tables' bytes, its maps within 1e-5 of the uniform
     mode's; no table rebuilt after the first call; the uniform mode split
     into table builds, FFTs and rings_to_map; the v2 analysis against the
     uniform analysis; at order 10 every mode against a float64 uniform
     run; the port's default mode must be the fastest (5 % slack);
 10. the deposit schemes and sky cuts at the headline shape, through
     Raytracer.step: SPH (one warm-up plane, one timed, one Profile'd;
     K1 launched exactly 8 times and K2 once per j-block, nothing else; the
     per-bucket windows built once and timed), beside one kernel_bl window
     by scipy's eval_legendre and by the port's recurrence at lmax 1023;
     CIC in the octant box (ra 0-90, dec 0-90, bundleOrder 3: ray count,
     masked pixels, the same planes, then its order-8 lens maps against
     float64 host sums); for both, one plane's deposit twice and one
     plane twice from the same rays (with its order-8 lens maps), equal
     bit for bit; one UseHEALPixLensPlaneMaps plane from the
     headline rays, its map the headline particles' NGP counts written as
     a <f4 file: its density equal to the particle deposit's bit for bit,
     the particle plane run twice equal bit for bit, and the mass-map
     plane's rays equal to the particle plane's bit for bit;
 11. CUDA vs CPU traces of the new paths at SHTOrder 7 / rayOrder 6 (2
     planes each, 5e-4, the same ray pixels, the launches per plane
     exact): SPH, CIC in a 40 x 40 degree box, and precomputed mass-map
     planes;
 12. the galaxy image search and the CMB mode: Raytracer.run at the
     headline shape over 8 planes with Profile on, each plane's 2^21
     particles through load_particles, GalsFileList naming 10^6 sources
     at 300-1900 Mpc/h (written by the port's write_source_gals) and
     GalOutputName set: K1 once and K2 once per j-block per plane and nothing
     else, every source imaged at least once (the catalogs read back), the
     sources with more than one image, each plane's GRIDSEARCH and step
     times and the peak memory; the search alone on the run's rays before
     plane 4, 10^6 sources in its bin (tools/bench_gals.py's shape):
     find_images_device (its dispatch under
     torch.cuda.set_sync_debug_mode("error"), so a host sync there fails)
     and find_images_born, in gals/s; 16384 of those sources searched on
     the same float32 buffer on the card, on the CPU and in float64 on the
     card (index multisets equal; card vs CPU, positions within 1e-3 of a
     ray pixel off the polar caps, positions and A within twice the
     float32 search's distance from float64); a legacy restart of the run's final rays loaded by a new
     Raytracer and run_cmb_mode at CMBMapOrder 10 (12,582,912 rays counted,
     their radii chi(1100) within 1e-6, the three files read back); at
     SHTOrder 7 / rayOrder 6, Raytracer.run with 20,000 sources on the CPU
     and on the card (per plane the imaged sources equal but for at most 1
     in 10^3, each printed) and the CMB mode from one legacy restart on
     both (5e-4);
 13. the multigrid step and the ray outputs: the MG design point
     (SHTOrder 10, rayOrder 12: 201,326,592 rays, bundleOrder 6: 49,152
     patches of 130^2, 2^21 particles, f32, NGP map and CIC patch
     deposits, 10 fixed V-cycles) through Raytracer.step: one warm-up and
     one timed, Profile'd plane (s/plane, rays/s, the phase row, the peak
     device memory under 80 GB, K1 and K2-4col launched exactly once per
     plane and nothing else) and one plane with its parts timed by
     CUDA events (SHT solve, patch deposit, BC fill, FAS solve, ray
     interpolation, propagation), then that plane again from the same rays
     and its patch deposit twice, each pair equal bit for bit; one plane
     with MGConvFact 0.1 and SPH (then its spline patch deposit twice,
     equal bit for bit)
     (its V-cycles); 2-plane CUDA-vs-CPU MG traces at SHTOrder 5 /
     rayOrder 6 / bundleOrder 2 with the defaults and with MGConvFact 0.1
     + SPH (5e-4, V-cycles printed); the headline rays after phase 5's
     plane 3 written by Raytracer.write_rays in 4 files as FITS and as
     binary (seconds, bytes), read back and held to a float64 transform
     of the same buffer (each column within twice the float32 CPU
     transform's distance from it); Raytracer.run at order 7/6 with
     MaxResMap, RayOutputName, OutputRayDeflections, OutputPhi and
     DebugIO on the card, on the CPU and in float64 on the CPU, the card's
     files within 5e-4 of the CPU's (or, after 8 planes, twice the
     float32 CPU files' distance from the float64 ones);
 14. the THREEDPOT path (fftpot.py) at full width: 2^27 particles from a
     numpy seed (uniform, a quarter in 4096 Gaussian clumps of 2 Mpc/h)
     in a 1050 Mpc/h box, written by the port's io/lgadget as two files
     in a temporary directory (kept for phase 17 in a whole run);
     ThreeDPot with NFFT 1024, rayOrder 10, float32, 4 planes of 25
     Mpc/h to 100 Mpc/h (nint 48; not the cell's 40 planes to 1000 Mpc/h,
     for the smoke's time) through
     Raytracer.step: one grid build, s/plane (first, median, last, with
     their radii), rays/s, the peak device memory under 80 GB, plane 0
     (with the build) by parts with CUDA events (snapshot read, upload,
     CIC deposit, FFT solve, path sampling, propagation); the last plane
     twice from the same rays, equal bit for bit; the grid built again
     with cuFFT's plan cache as it is and cleared (peaks; each equal to the
     first build bit for bit); the grid deposit of both files twice (equal
     bit for bit, its time beside the one measured before its sums had a
     fixed order); the deposit's float64 total within 1e-6 of the
     particle count; the
     float32 potential against float64 of the same counts (bound: twice
     the card's distance at NFFT 128; the CPU's there printed beside it);
     the float32 fields of 2^14 rays against float64 sampling of the same
     grid (bound: twice the same comparison on the CPU, same grid and
     rays); a 4-plane card-vs-CPU trace (box 200, NFFT 64, rayOrder 6,
     float32, two snapshots, one in two files: the nearest snapshot
     switches, each grid built once) within 5e-4.  The lens-plane maker and
     the lightcone readers (io/lightcone.py, lensplane_maker.py) are host
     numpy and h5py with no device path, and the card's machine has no
     h5py: no phase drives them (tests/test_torch_lightcone.py and
     tests/test_torch_copies.py do, on the CPU);
 15. the j-block streamed synthesis (sht/transforms.py) and NSIDE 8192:
     SHTOrder 13 (lmax 24575) / rayOrder 12 (201,326,592 rays), 2^24
     particles, f32, full sky, NGP, through Raytracer.step: the plan's and
     the rays' build seconds, one warm-up plane, one timed and Profile'd
     (s/plane, rays/s), each plane's launches exact (K1 once, K2 once per
     j-block), the peak memory after a reset under 80 GB; K1
     and K2 at order 13 against their twins on 9 m rows (K2 on the windows
     of the first and the last block), K4 against K1, K1's and K4's ms and
     K2's summed over the blocks; K1 and K4 launched twice (equal bits)
     and on a block of m rows (equal to the whole launch's rows), K2,
     K2-4col and K3 in both forms twice on the first window (equal
     bits); the analysis ring stage with its 6.4 GB phase table
     applied in row blocks (the plan's policy) and kept (ms, peaks); one
     point mass (5e16 at 625 Mpc/h) from fresh rays,
     alpha of every 64th ray at 0.15-0.6 rad within 2 % (median) of
     pointmass.alpha_exact, its direction's median cosine above 0.999;
     Raytracer.run over two planes with 10^6 sources in plane 1's bin,
     every source imaged, gals/s and the peak (its closing 16.9 GB npz
     restart left out); then the synthesis at every candidate block count
     at orders 12-13 on one alm (at order 12 1, 8 and 32, at 13 16 and
     32; orders 10-11 and the counts that never beat the fastest, and the
     order-13 per-block tables kept, which the port does not keep, are
     left out for the smoke's time), timed, against the
     unstreamed synthesis (order 13: the default count) within 1e-5 of
     each map's max, the default count within 15 % of the fastest, and at
     order 12 K3 through the synthesis at 32 blocks (each window with its
     own seed pre-pass, launches exact) against K3 unstreamed within the
     same bound;
 16. the multi-device path (calclens_tpu_torch/parallel/) on ranks that
     share the card (the machine has one; each rank a process spawned by
     parallel/launch.run_ranks, with its own timeout): K1-K4 on a block
     of m rows (their m0 argument) against the whole launch's rows at
     order 10, equal bit for bit; that gloo takes each collective
     primitive on CUDA tensors (2 ranks; a refused one fails the phase);
     NCCL at world size 1 (every
     Mesh collective an identity, the sharded 2-plane trace at order 7/6
     vs the one-device trace within 5e-4); the headline (SHTOrder 12,
     rayOrder 10, 2^21 particles, f32, NGP, 1 warm-up and 1 timed,
     Profile'd plane)
     on 2 ranks sharing the card over gloo against one rank: each rank's
     step seconds, K1 and K2 ms and launches per plane (exactly one each),
     each rank's peak and their sum under 80 GB, A and alpha within
     P16_HEAD_BOUNDS of each quantity's max, the order-8 lens map counts
     equal; the
     order-7/6 traces (2 planes: NGP, SPH, 4 forced j-blocks, K3 + K4;
     launches per rank per plane exact) and a 4-plane Raytracer.run with
     lens maps, two ray files and 2000 galaxy sources, on 2 and 4 ranks
     against one rank on the card: rays within 5e-4, ray files' layout and
     NEST columns equal, lens map ray counts equal, the imaged sources
     equal but for 1e-3 of them.  The ranks share one card: their times are
     not a scaling result;
 17. the sharded multigrid step and the slab-decomposed THREEDPOT solve
     (mgdriver.mg_refine and fftpot.ThreeDPotDriver on a mesh,
     parallel/slabfft.py) on 2 gloo ranks sharing the card, each against
     one rank on the card: the MG design point (phase 13's shape; plane 1
     untimed, plane 2 timed and Profile'd) with each rank's phase row,
     the collectives' seconds (each between two syncs) and the bytes it
     sent (from the shapes), its launches (K1 and K2-4col once), V-cycles
     and peak, the peaks' sum under 80 GB, A and alpha within
     P17_MG_BOUNDS of their max; THREEDPOT at phase 14's shape (its
     snapshot written again, one file per rank) over 2 planes, plane 0 by
     parts (CUDA events) with the collectives, each rank's x rows of the
     potential against the one-device grid within twice phase 14's bound
     on the card's float32 distance (the slab solve rounds a second
     float32 transform), the rays within 5e-4, the ranks' particles
     summing to the snapshot's; the MG traces at SHTOrder 5 / rayOrder 6 /
     bundleOrder 2 (defaults, and MGConvFact 0.1 with SPH; 2 planes, the
     V-cycles equal to one rank's, launches per plane exact) and a
     THREEDPOT trace (phase 14's, NFFT 64) on 2 and 4 ranks and on NCCL at
     world size 1, against one rank within 5e-4.  The one-rank references
     reach the ranks as files in a temporary directory (~10 GB).

`python3 chip_smoke.py --phase 15` (or `--phase 16`, `--phase 17`) runs the
build and that phase alone and prints no JSON line.

Before the JSON lines it prints, each beside the card's name and power
limit, K1's and K4's ms at orders 10, 12 and 13 and the headline, SPH, MG,
THREEDPOT and order-13 step times and peaks beside the numbers measured
before the plane step was bit-reproducible (BEFORE_KERNEL_MS,
BEFORE_STEPS).

It prints the card's line, a JSON line {"kernels": [...]} with each
kernel's launches on its path's run, its error against its twin, its
times, its bound and the library column, and last {"ok": true, "device":
{...}}.  It exits non-zero, printing neither JSON line, when a phase fails
or there is no GPU.
"""

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

K1_BOUND = 1e-5   # kernel vs twin, relative to max |twin|
K2_BOUND = 1e-5
VARIANT_BOUND = 1e-5  # K3, K4, K2-4col vs twins; K4 vs K1; alm2map vs K2
# CUDA vs CPU trace, relative to each quantity's max |value|: 4x below the
# float32 trace's own distance from a float64 trace at these shapes (2e-3 on
# the A rows, measured on an H100), so the kernels' path must agree with
# the twins' far better than either agrees with the exact answer
TRACE_BOUND = 5e-4
# what the port measured before its plane step was bit-reproducible, printed
# beside this run's numbers (PERF.md; K1 and K4 at order 10: this script's
# phase 3 on that design; K4 at order 13 was not run): K1 and K4 ms; per
# step configuration s/plane and peak GiB; THREEDPOT's grid deposit ms
BEFORE_KERNEL_MS = {("legendre_analysis", 10): 3.853,
                    ("legendre_analysis", 12): 178.41,
                    ("legendre_analysis", 13): 1359.18,
                    ("legendre_analysis_dot", 10): 5.096,
                    ("legendre_analysis_dot", 12): 238.11}
BEFORE_STEPS = {"headline": (0.7438, 34.82), "SPH headline": (2.1786, 34.76),
                "MG design point": (6.7441, 41.81),
                "THREEDPOT": (1.4552, 37.12), "order 13": (5.9474, 61.54)}
BEFORE_TDP_DEPOSIT_MS = 147.40
# lens map at order 8 on the card (float32 sums of 16 rays per pixel)
# against a float64 host accumulation, relative to each row's max
MAP_BOUND = 1e-5
MAP_ORDER = 8
# the synthesis ring stages: each mode's maps against the "uniform" mode's
# on the same float32 streams at order 12, and every mode against a float64
# "uniform" run at order 10, relative to max |reference|; the v2 analysis
# against the uniform analysis on the columns both compute, the same way
RING_BOUND = 1e-5
RING_ORDERS = (12, 10)
# the default mode may lie this far above the fastest one measured (noise
# between calls)
RING_DEFAULT_SLACK = 0.05
# P1 probe vs its plain version, relative to max |plain|: the same roundings
# (0 expected); dot sums its FMAs in another order
PROBE_BOUND = 1e-6
PROBE_DOT_BOUND = 1e-5
# shapes at which the probe's recurrence stays finite and every mode is
# held to its plain version: one m row per 512-thread block with 8-degree
# refills (16 degrees, m < 128); and the timed layout of ceilings() (two m
# rows per 256-ring block, 128-degree refills) on two blocks of rows and
# two refills (256 degrees, m < 4)
PROBE_CHECKS = (dict(MT=4, LBLK=2, LB=8, TM=32, TJ=512),
                dict(MT=2, LBLK=2, LB=128, TM=2, TJ=256))
# m rows on which the order-12 outputs of K2-4col, K3 and K4 are held to
# their twins: both parities, the first rows, and rows up to lmax
CHECK_ROWS = (0, 1, 2, 3, 511, 2048, 6143, 10001, 12287)
# launches timed of K3's seed pre-pass, well under a millisecond: enough
# that the first launch's host latency does not weigh in the mean
SEED_REPS = 20

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32 outside
# the tensor cores, dense TF32 on the tensor cores, and device memory.
FP32_PEAK = 67e12   # FLOP/s
TF32_PEAK = 495e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# FP32 operations per (l, m, j) element that the function needs on the CUDA
# cores (a fused multiply-add counts 2): the recurrence 5 (three
# multiplies, a subtraction, the scale multiply); K1 adds 2 FMAs (re, im);
# K2 8 FMAs (16 columns) or 2 (4 columns).  K3 with derivatives computes
# the same (qN, qS) as K2: its lambda' and lambda'' sums follow, summed by
# parts, from sums of a*lambda, l*a*lambda and l(l+1)*a*lambda, so the
# function needs K2's 21, although K3 forms lambda' and lambda'' per
# degree (11 more); without derivatives K2-4col's 9.  K4 contracts on the
# tensor cores, so only its recurrence (5) runs on the CUDA cores; its 2
# products per element are charged in TF32_FLOPS_PER_ELEMENT.  Per-degree
# coefficients are shared by a block's rings and not counted.  K3's seed
# pre-pass: 2 multiplies per (m, ring).
FLOPS_PER_ELEMENT = {"legendre_analysis": 9, "legendre_analysis_dot": 5,
                     "legendre_synth": 21, "legendre_synth_phi": 9,
                     "legendre_synth_vpu": 21, "legendre_synth_vpu_phi": 9,
                     "legendre_chain_seed": 2}
# TF32 tensor-core operations per element: K4's 2 float32 products (re,
# im), each at least 3 TF32 products (hi.hi + hi.lo + lo.hi) to keep
# float32 accuracy, 2 operations each.  A kernel's operations take the
# longer of its CUDA-core and its tensor-core time.
TF32_FLOPS_PER_ELEMENT = {"legendre_analysis_dot": 12}
# Issue slots per element that the rounding contract needs on the CUDA
# cores: the recurrence's 4 operations, each rounded (no FMA), and one slot
# per column FMA (K1 2, K2 8, K2-4col 2; K4's products run on the tensor
# cores: none).  K3 forms lambda' (5 rounded operations: l cot, times
# lambda, c_lm lambda_{l-1}, times 1/sin, the difference) and lambda'' (4:
# m^2/sin^2 - l(l+1), times lambda, cot lambda', the difference) per degree
# and adds 6 bucket FMAs: 19 with derivatives, 4 + 2 = 6 without.  The card
# issues at most one warp instruction per scheduler and clock: 132 SMs x 4
# schedulers x 32 lanes x 1980 MHz.
SLOTS_PER_ELEMENT = {"legendre_analysis": 6, "legendre_analysis_dot": 4,
                     "legendre_synth": 12, "legendre_synth_phi": 6,
                     "legendre_synth_vpu": 19, "legendre_synth_vpu_phi": 6}
SLOT_RATE = 132 * 4 * 32 * 1980e6  # thread-instructions/s


# phase 12, the galaxy image search and the CMB mode: (SHTOrder, rayOrder)
# and particles per plane of its headline run and of its card-vs-CPU runs;
# sources of the headline run's catalog and of the search alone, of the
# CPU-vs-card search on one buffer, and of the order-7/6 runs
GALS_HEAD_ORDERS = (12, 10)
GALS_HEAD_PARTICLES = 1 << 21
GALS_TRACE_ORDERS = (7, 6)
GALS_HEADLINE = 10**6
GALS_CPU_CHECK = 16384
GALS_TRACE = 20000
# the headline rays are snapshotted before this plane's step for the
# search alone (sources in its radial bin)
GALS_SEARCH_PLANE = 4
# the search on one float32 buffer, card vs CPU: image positions within
# this share of a ray pixel (the dedup's own tolerance) outside the polar
# caps (|dec| > GALS_POLAR_DEC), where float32 arccos and the parallel
# transport's 1 - z lose their digits (there a float32 search lies 3.4e-3
# of a pixel and 4.9e-3 of max |A| from a float64 search of its buffer, on
# an H100); and everywhere within GALS_F64_FACTOR times the card's own
# float32 distance from that float64 search: the CPU and the card round
# transcendentals their own ways, and float32 A lies ~2e-5 of max |A| from
# float64 off the caps too (both printed by this phase)
GALS_POS_BOUND = 1e-3
GALS_POLAR_DEC = 80.0
GALS_F64_FACTOR = 2.0
# the order-7/6 run with galaxies, card vs CPU: the traces lie up to
# TRACE_BOUND apart, so a source next to a triangle edge may be imaged on
# one device and not the other; at most this share of a plane's sources
GALS_SET_SLACK = 1e-3
# the CMB radii: float32 rays against chi(1100)
CMB_RADIUS_BOUND = 1e-6
CMB_MAP_ORDER = 10
# phase 13, the multigrid step and the ray outputs: the MG design point
# (bench.py's BENCH_MODE=MG: SHTOrder, rayOrder, bundleOrder), its
# particles and its fixed V-cycles, and the small card-vs-CPU MG trace
MG_ORDERS = (10, 12, 6)
# the design point's planes through Raytracer.step: the first a warm-up,
# the last timed and Profile'd (then one plane by parts)
MG_DESIGN_PLANES = (1, 2)
MG_PARTICLES = 1 << 21
MG_TRACE_ORDERS = (5, 6, 2)
# the planes of each small MG trace (phases 13 and 17)
MG_TRACE_PLANES = 2
# the MG step's parts (poisson.plane_step_mg's phase tags)
MG_PARTS = ("DEPOSIT", "SHTSOLVE", "SHT", "MGDEPOSIT", "MGBC", "MGSOLVE",
            "MGINTERP", "RAYPROP")
# ray files of the headline rays: files per write, and the bound of the
# card's columns against a float64 transform of the same buffer, as a
# multiple of the float32 CPU transform's own distance from it
RAY_FILES = 4
RAY_F64_FACTOR = 2.0
DEVICE_MEMORY = 80e9
# phase 14, the THREEDPOT path (fftpot.py) at full width: particles of one
# snapshot (uniform, plus TDP_CLUMP_SHARE of them in TDP_CLUMPS Gaussian
# clumps of TDP_CLUMP_SIGMA Mpc/h, structure on the grid's scale) written
# as two LGadget files, box, grid, rays, depth and shells of 25 Mpc/h
# (nint = 48 samples per ray and plane)
TDP_PARTICLES = 1 << 27
TDP_BOX = 1050.0
TDP_NFFT = 1024
TDP_RAY_ORDER = 10
TDP_MAX_DIST = 100.0
TDP_PLANES = 4
TDP_CLUMPS = 4096
TDP_CLUMP_SHARE = 0.25
TDP_CLUMP_SIGMA = 2.0
# the deposit's float64 total against the particle count, relative
TDP_DEPOSIT_BOUND = 1e-6
# the float32 potential and the float32 fields of TDP_CHECK_RAYS rays at
# plane TDP_CHECK_PLANE against float64 on the card: the potential within
# TDP_F64_FACTOR times the same comparison on the card at NFFT
# TDP_CPU_NFFT (the same counts deposited on the coarse grid; the CPU's
# distance there is printed beside it: MKL's float32 transform lies nearer
# float64 than cuFFT's at equal size, so the CPU cannot bound the card's
# transform), the fields within
# TDP_F64_FACTOR times the CPU's distance on the same grid and rays (in
# float32 a second difference loses digits as the cells shrink, so a
# coarser grid would not bound a finer one)
TDP_CHECK_RAYS = 1 << 14
TDP_CHECK_PLANE = 3
TDP_CPU_NFFT = 128
TDP_F64_FACTOR = 2.0
# the card-vs-CPU trace: box, grid, rays, planes over maxComvDistance, and
# two snapshots (at these comoving distances; the second in two files) of
# this many particles and clumps each, so the nearest snapshot switches
# after plane 1 and each grid is built once
TDP_TRACE = dict(box=200.0, nfft=64, ray_order=6, planes=4, max_dist=400.0,
                 snap_chi=(100.0, 300.0), particles=1 << 16, clumps=64)
# the THREEDPOT step's parts (fftpot.ThreeDPotDriver's phase tags)
TDP_PARTS = ("PARTIO", "UPLOAD", "DEPOSIT", "FFTSOLVE", "FFTSAMPLE",
             "RAYPROP")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*args):
    print(*args, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def col_errs(got, ref):
    """(max over output columns of the relative error, max abs error) of
    [rows, ncol, J] outputs."""
    return (max(rel_err(got[:, c], ref[:, c]) for c in range(got.shape[1])),
            float((got - ref).abs().max()))


def pair_errs(got, ref):
    """The same for (re, im) pairs of alm outputs."""
    return (max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1])),
            max(float((got[0] - ref[0]).abs().max()),
                float((got[1] - ref[1]).abs().max())))


def launched_twice(fn):
    """Whether two calls of fn (a kernel's launch) on the same inputs give
    the same bits: a tensor or a tuple of tensors."""
    import torch

    a = fn()
    b = fn()
    a, b = ((x,) if isinstance(x, torch.Tensor) else x for x in (a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kernels_twice(plan, streams, ana, analysis=True):
    """K1, K2 and the variant kernels (variant_calls: K2-4col, K3 in both
    forms, K4) each launched twice on the same inputs: name -> equal bits;
    without analysis K2, K2-4col and K3 alone.  plan may be a
    RingPairWindow: the synthesis kernels then run on its ring pairs, K1
    and K4 on all of ana's."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL

    calls = {name.split()[1]: kern for name, (kern, _, _)
             in variant_calls(plan, streams, ana).items()}
    geo = (plan.cth, plan.ln_sth, plan.logc, plan.mcut(TL.SYNTH_TILE_J))
    calls["legendre_synth"] = lambda: TL.synth_cuda(streams, *geo)
    calls["legendre_analysis"] = lambda: TL.analysis_cuda(*ana, plan.nl)
    if not analysis:
        del calls["legendre_analysis"], calls["legendre_analysis_dot"]
    out = {}
    for name, fn in calls.items():
        out[name] = launched_twice(fn)
        torch.cuda.empty_cache()
    return out


def block_rows(plan, streams, ana, full=None):
    """The kernels launched on one block of m rows [nm / 3, nm / 3 + nm /
    4) (their m0 argument, as each rank of a mesh launches them) against
    the whole launch's rows: name -> (relative, absolute) error, 0 when
    the rows are equal bit for bit; K1 and K4 (full: their whole
    launches' outputs where already made), and with streams K2 and K3
    too.  Returns (errors, (m0, m1))."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL

    m0, m1 = plan.nm // 3, plan.nm // 3 + plan.nm // 4
    logc = plan.logc[m0:m1].contiguous()
    out = {}
    if streams is not None:
        mcut2 = plan.mcut(TL.SYNTH_TILE_J)
        g3 = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
        rows = [x[m0:m1].contiguous() for x in streams]
        whole = TL.synth_cuda(streams, plan.cth, plan.ln_sth, plan.logc,
                              mcut2)
        part = TL.synth_cuda(rows, plan.cth, plan.ln_sth, logc, mcut2, m0)
        out["legendre_synth"] = col_errs(part, whole[m0:m1])
        whole = TL.synth_vpu_cuda(*streams[:2], *g3, True, mcut2)
        part = TL.synth_vpu_cuda(*rows[:2], *g3, True, mcut2, m0=m0)
        out["legendre_synth_vpu"] = col_errs(part, whole[m0:m1])
        del rows
    ana_rows = (*(x[m0:m1].contiguous() for x in ana[:4]), plan.cth,
                plan.ln_sth, logc, ana[7])
    for name, fn in (("legendre_analysis", TL.analysis_cuda),
                     ("legendre_analysis_dot", TL.analysis_dot_cuda)):
        whole = (full or {}).get(name) or fn(*ana, plan.nl)
        part = fn(*ana_rows, plan.nl, m0)
        out[name] = pair_errs(part, tuple(x[m0:m1] for x in whole))
    del ana_rows, whole, part
    torch.cuda.empty_cache()
    return out, (m0, m1)


def report_bits(label, twice, rows, m_block):
    """Prints and checks kernels_twice's and block_rows' results: every
    kernel's two launches equal, every block's rows equal to the whole
    launch's."""
    say(f"{label}: launched twice on the same inputs, equal bits: "
        + ", ".join(f"{k} {v}" for k, v in twice.items())
        + f"; on m rows [{m_block[0]}, {m_block[1]}) vs the whole launch's "
        f"rows: " + ", ".join(f"{k} rel {v[0]:.3e} abs {v[1]:.3e}"
                              for k, v in rows.items()))
    check(all(twice.values()), f"{label}: a kernel's two launches differ: "
          f"{twice}")
    check(all(v[1] == 0.0 for v in rows.values()),
          f"{label}: a block of m rows differs from the whole launch's: "
          f"{rows}")


def repeat_plane(rt, plane, particles=(), maps_order=None):
    """rt's step of `plane` run twice from one state, the rays rt holds
    now (the first run from a copy of them): whether the two runs' rays
    (and, with maps_order, their lens maps at that order) are equal bit
    for bit, and each run's seconds.  rt keeps the second run's rays."""
    import torch
    from calclens_tpu_torch import maps as tmaps

    def maps(rays):
        return (None if maps_order is None else tmaps.accum_lens_map_packed(
            rays, rt._ray_nest, rt.cfg.rayOrder, maps_order))

    state = rt.rays_packed
    rt.rays_packed = state.clone()
    t = time.perf_counter()
    rt.step(plane, *particles)  # ends in torch.cuda.synchronize()
    secs = [time.perf_counter() - t]
    first, first_maps = rt.rays_packed, maps(rt.rays_packed)
    rt.rays_packed = state
    del state
    t = time.perf_counter()
    rt.step(plane, *particles)
    secs.append(time.perf_counter() - t)
    out = dict(equal=bool(torch.equal(first, rt.rays_packed)), s=secs,
               maps_equal=(None if maps_order is None else bool(
                   torch.equal(first_maps, maps(rt.rays_packed)))))
    del first, first_maps
    torch.cuda.empty_cache()
    return out


def deposit_twice(rt, plane, particles):
    """The plane's deposit (poisson.phase_deposit, as rt's step runs it)
    twice on the same particles: (equal bits, CUDA-event ms of each)."""
    import torch
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.poisson import phase_deposit, plane_scalars

    scal = plane_scalars(plane_params(rt.cfg, rt.cosmo, plane), rt.dtype,
                         rt.device)
    pos_d, mass_d = rt._pad_particles(*particles)
    outs, ms = [], []
    for _ in range(2):
        d, t = timed_once(lambda: phase_deposit(
            rt.plan, rt.tab, pos_d, mass_d, rt.cfg.DepositScheme, scal,
            rt.vacmask, rt.sph))
        outs.append(d)
        ms.append(t)
    equal = bool(torch.equal(*outs))
    del outs
    torch.cuda.empty_cache()
    return equal, ms


def band_limited_inputs(order, dev, seed):
    """(plan, alm, K2 stream planes, K1 input tuple) at one order: random
    alm with a red spectrum; the K1 inputs are the folded ring sums of the
    potential map synthesized from it.  The first two K2 streams are the
    a-streams of K2's 4-column form and of K3."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.plan import SHTPlan

    plan = SHTPlan(order, dev, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    l = np.arange(plan.nl)[:, None]
    m = np.arange(plan.nm)[None, :]
    alm = np.where(m <= l, (rng.normal(size=(plan.nl, plan.nm))
                            + 1j * rng.normal(size=(plan.nl, plan.nm)))
                   / (1.0 + l) ** 1.5, 0.0)
    alm[:, 0] = alm[:, 0].real
    alm = torch.tensor(alm.astype(np.complex64), device=dev)
    streams = TL.mx_prep(plan.nl, plan.nm, alm, torch.float32)
    phi = T.alm2allmaps(plan, alm)[0]
    E, O = T.fold_pairs(plan, T.analysis_rings(plan, phi))
    del phi
    return plan, alm, streams, TL.analysis_inputs(plan, E, O)


def compare_kernels(plan, streams, ana, reps):
    """K1 and K2 against their twins on the same inputs, with CUDA-event
    times: per kernel (max relative error over its output columns, max
    absolute error, kernel ms as the mean of `reps` launches after the
    compared one, twin ms of its one run)."""
    from calclens_tpu_torch.tools import cuda_ms
    from calclens_tpu_torch.sht import legendre as TL

    geo = (plan.cth, plan.ln_sth, plan.logc, plan.mcut(TL.SYNTH_TILE_J))
    got = TL.synth_cuda(streams, *geo)
    ref, k2_twin_ms = timed_once(lambda: TL.synth_plain(streams, *geo))
    k2 = (*col_errs(got, ref),
          cuda_ms(lambda: TL.synth_cuda(streams, *geo), reps),
          k2_twin_ms)
    del got, ref
    got = TL.analysis_cuda(*ana, plan.nl)
    ref, k1_twin_ms = timed_once(lambda: TL.analysis_plain(*ana, plan.nl))
    k1 = (*pair_errs(got, ref),
          cuda_ms(lambda: TL.analysis_cuda(*ana, plan.nl), reps),
          k1_twin_ms)
    return k1, k2


def variant_calls(plan, streams, ana):
    """name -> (kernel call, twin call on rows m or all rows, error pair
    function) for K2's 4-column form, K3 in both forms and K4."""
    from calclens_tpu_torch.sht import legendre as TL

    a2 = streams[:2]
    mcut = plan.mcut(TL.SYNTH_TILE_J)
    g2 = (plan.cth, plan.ln_sth, plan.logc, mcut)
    g3 = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
    # K3 runs on its seed table, written once here: its times leave out the
    # pre-pass, which is timed on its own (check_seed_table)
    seed = TL.chain_seed_cuda(plan.sth, plan.nm)

    def rows(x, m):
        return x if m is None else x[m]

    def k2phi_twin(m):
        return TL.synth_plain(tuple(rows(a, m) for a in a2), plan.cth,
                              plan.ln_sth, rows(plan.logc, m), mcut, m=m)

    def k3_twin(derivs):
        return lambda m: TL.synth_vpu_plain(rows(a2[0], m), rows(a2[1], m),
                                            *g3, derivs, m=m, mcut=mcut)

    def k4_twin(m):
        return TL.analysis_dot_plain(*(rows(x, m) for x in ana[:4]),
                                     plan.cth, plan.ln_sth,
                                     rows(plan.logc, m), ana[7], plan.nl,
                                     m=m)

    return {
        "K2-4col legendre_synth_phi": (
            lambda: TL.synth_cuda(a2, *g2), k2phi_twin, col_errs),
        "K3 legendre_synth_vpu": (
            lambda: TL.synth_vpu_cuda(*a2, *g3, True, mcut, seed),
            k3_twin(True), col_errs),
        "K3-phi legendre_synth_vpu_phi": (
            lambda: TL.synth_vpu_cuda(*a2, *g3, False, mcut, seed),
            k3_twin(False), col_errs),
        "K4 legendre_analysis_dot": (
            lambda: TL.analysis_dot_cuda(*ana, plan.nl), k4_twin, pair_errs),
    }


def compare_variants(plan, streams, ana, reps):
    """Each variant kernel against its full twin: name -> (rel, abs,
    kernel ms, twin ms)."""
    from calclens_tpu_torch.tools import cuda_ms
    import torch

    out = {}
    for name, (kern, twin, errs) in variant_calls(plan, streams,
                                                  ana).items():
        got = kern()
        ref, twin_ms = timed_once(lambda: twin(None))
        out[name] = (*errs(got, ref), cuda_ms(kern, reps), twin_ms)
        del got, ref
        torch.cuda.empty_cache()
    return out


def check_variant_rows(plan, streams, ana, reps):
    """At the headline shape: each variant kernel's full output, on the
    CHECK_ROWS rows, against its twin run on those rows alone: name ->
    (rel, abs, kernel ms)."""
    from calclens_tpu_torch.tools import cuda_ms
    import torch

    m = torch.tensor(CHECK_ROWS, device=plan.device)
    out = {}
    for name, (kern, twin, errs) in variant_calls(plan, streams,
                                                  ana).items():
        got = kern()
        got = got[m] if isinstance(got, torch.Tensor) else tuple(
            x[m] for x in got)
        out[name] = (*errs(got, twin(m)), cuda_ms(kern, reps))
        del got
        torch.cuda.empty_cache()
    return out


def check_seed_table(plan):
    """K3's seed pre-pass against the twin's chain (chain_seed of every m)
    on the card: bit for bit, values and counters; printed with its share
    of its bound.  Returns (max abs error, pre-pass ms as the mean of
    SEED_REPS launches, twin ms)."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.tools import cuda_ms

    got, got_k = TL.chain_seed_cuda(plan.sth, plan.nm)
    m = torch.arange(plan.nm, device=plan.device)
    (ref, ref_k), twin_ms = timed_once(lambda: TL.chain_seed(m, plan.sth))
    check(torch.equal(got, ref) and torch.equal(got_k, ref_k),
          f"K3 seed table off the chain at order {plan.order}")
    err = float((got - ref).abs().max())
    del got, got_k, ref, ref_k
    ms = cuda_ms(lambda: TL.chain_seed_cuda(plan.sth, plan.nm), SEED_REPS)
    bound = kernel_bounds(plan)["legendre_chain_seed"]["bound_ms"]
    say(f"order {plan.order} K3 seed pre-pass legendre_chain_seed: equal to "
        f"the twin's chain bit for bit; kernel {ms:.4f} ms, "
        f"{100 * bound / ms:.1f} % of its {bound:.4f} ms bound (bytes); "
        f"twin {twin_ms:.1f} ms")
    return err, ms, twin_ms


def kernel_bounds(plan):
    """name -> dict(bound_ms, bound_by, full_bound_ms, floor_ms, elems) at
    this plan's shape.  The bound is the larger of the operations' time
    (FP32 over FP32_PEAK, or K4's tensor-core TF32 over TF32_PEAK where that
    is longer) and the bytes that must move (each input read once, each
    output written once) over HBM_RATE, on the elements these inputs need
    (roofline_legendre.element_counts: for K1 and K4 only the (m, 512-ring
    tile) pairs below the tile's turning-point cutoff, for K2 and K3 (both
    forms) those below their 128-ring tiles' cutoff); full_bound_ms is the
    same on the full triangle (before the cutoff).  floor_ms:
    SLOTS_PER_ELEMENT per element over SLOT_RATE.  K3's seed pre-pass
    computes nm J (m, ring) pairs and writes 8 bytes for each (no floor)."""
    from calclens_tpu_torch.sht.legendre import ANALYSIS_TILE_J as T1
    from calclens_tpu_torch.tools import roofline_legendre as R

    nl, nm, J = plan.nl, plan.nm, plan.J
    tri_m = np.maximum(nl - np.arange(nm), 0).astype(np.float64)  # per m
    tri = float(tri_m.sum())
    rings = [min(T1, J - t) for t in range(0, J, T1)]
    cut = plan.mcut(T1).cpu().numpy()
    ana_in = sum(r * int(c) for r, c in zip(rings, cut))  # (m, j) needed
    f4 = 4.0
    nbytes = {
        "legendre_analysis": f4 * (4 * ana_in + 2 * tri + 2 * J),
        "legendre_synth": f4 * (4 * tri + 16 * nm * J + 2 * J),
        "legendre_synth_phi": f4 * (2 * tri + 4 * nm * J + 2 * J),
        "legendre_synth_vpu": f4 * (2 * tri + 12 * nm * J + 4 * J),
        "legendre_synth_vpu_phi": f4 * (2 * tri + 4 * nm * J + 4 * J),
        "legendre_chain_seed": f4 * (2 * nm * J + J),
    }
    nbytes["legendre_analysis_dot"] = nbytes["legendre_analysis"]
    elems = R.element_counts(plan)

    def bound(name, n):
        t_ops = n * max(FLOPS_PER_ELEMENT[name] / FP32_PEAK,
                        TF32_FLOPS_PER_ELEMENT.get(name, 0) / TF32_PEAK)
        t_mem = nbytes[name] / HBM_RATE
        return (1e3 * max(t_ops, t_mem),
                "operations" if t_ops >= t_mem else "bytes")

    out = {}
    for name, n in elems.items():
        b, by = bound(name, n)
        out[name] = dict(bound_ms=b, bound_by=by,
                         full_bound_ms=bound(name, tri * J)[0],
                         floor_ms=1e3 * SLOTS_PER_ELEMENT[name] * n
                         / SLOT_RATE,
                         elems=n)
    b, by = bound("legendre_chain_seed", nm * J)
    out["legendre_chain_seed"] = dict(bound_ms=b, bound_by=by,
                                      full_bound_ms=b, floor_ms=None,
                                      elems=nm * J)
    return out


def distance_from_f64(plan, alm, q2, q3):
    """How far K2's and K3's float32 (qN, qS) lie from the exact answer, on
    the CHECK_ROWS rows: float64 twins of both (they agree to round-off, a
    check that the reference does not depend on the seed) on a float64
    plan.  Returns (twins' distance, {kernel: ([(cap, belt) per quantity],
    [d_theta per row])}), each max |q - ref| / max |ref| of the quantity
    over those rows; the polar caps are the ring pairs j < nside (theta <=
    48.2 deg), the belt the rest."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht.plan import SHTPlan

    p64 = SHTPlan(plan.order, plan.device, dtype=torch.float64)
    m = torch.tensor(CHECK_ROWS, device=plan.device)
    sub = tuple(x[m] for x in TL.mx_prep(p64.nl, p64.nm,
                                         alm.to(torch.complex128),
                                         torch.float64))
    ref = TL.q_from_columns(p64, TL.synth_plain(
        sub, p64.cth, p64.ln_sth, p64.logc[m], m=m), m=m)
    ref3 = TL.q_from_buckets(p64, TL.synth_vpu_plain(
        sub[0], sub[1], p64.cth, p64.sth, p64.cot, p64.inv_sth, True, m=m),
        m=m)
    twins = max(rel_err(ref3[h][k], ref[h][k]) for h in (0, 1)
                for k in range(3))
    cap = torch.arange(plan.J, device=plan.device) < plan.nside
    out = {}
    for name, q in (("K2", q2), ("K3", q3)):
        per_q, per_row = [], None
        for k in range(3):
            scale = max(float(ref[h][k].abs().max()) for h in (0, 1))
            d = torch.stack([(q[h][k][m].to(torch.complex128)
                              - ref[h][k]).abs() for h in (0, 1)])
            per_q.append((float(d[..., cap].max()) / scale,
                          float(d[..., ~cap].max()) / scale))
            if k == 1:
                per_row = (d.amax(dim=(0, 2)) / scale).tolist()
        out[name] = (per_q, per_row)
    return twins, out


def ring_streams(plan, alm):
    """Two synthesis streams [2, nrings_pad, nm] as the plane step makes
    them: K2's (phi, d_theta) q rows of alm through unfold_pairs."""
    import torch
    from calclens_tpu_torch.sht import transforms as T

    qN, qS = T.legendre_synthesis(plan, alm, True)
    Q = torch.stack([T.unfold_pairs(plan, qN[k], qS[k]) for k in range(2)])
    del qN, qS
    return Q


def ring_stage_modes(plan, Q, reps=3):
    """Each synthesis ring stage on the same streams Q: mode -> dict(maps,
    first_s (host clock of the first call, its tables built in it), ms
    (CUDA events, mean of `reps` after a warm-up), peak_gib (peak device
    memory of a call above what was allocated before it), table_bytes)."""
    import torch
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.czt import TableCache
    from calclens_tpu_torch.sht.plan import SYNTHESIS_RINGS_MODES
    from calclens_tpu_torch.tools import cuda_ms

    out = {}
    for mode in SYNTHESIS_RINGS_MODES:
        plan.synthesis_rings_mode = mode
        plan.tables, plan._ring_stage = TableCache(plan.device), None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = T.synthesis_rings(plan, Q)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        builds = plan.tables.builds
        ms = cuda_ms(lambda: T.synthesis_rings(plan, Q), reps)
        check(plan.tables.builds == builds, f"ring stage {mode} rebuilt a "
              f"table after its first call")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        again = T.synthesis_rings(plan, Q)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        check(torch.equal(again, maps), f"ring stage {mode}: a second call "
              f"differs from the first")
        del again
        out[mode] = dict(maps=maps, first_s=first_s, ms=ms, peak_gib=peak,
                         table_bytes={k: plan.tables.nbytes(k) for k in (
                             "czt", "synthesis_phase", "fold", "assembly",
                             "rings_to_map")},
                         builds=builds)
    plan.synthesis_rings_mode = "uniform"
    return out


def uniform_split(plan, Q, reps=3):
    """The uniform synthesis split: (seconds to build each of its tables on
    a new cache, ms per part at steady state: the weight and phase multiply,
    the blocked chirp-Z FFTs, rings_to_map)."""
    import torch
    from calclens_tpu_torch.sht.czt import TableCache, czt_blocked
    from calclens_tpu_torch.tools import cuda_ms

    plan.tables = TableCache(plan.device)
    build = {}
    for name, fn in (
            ("synthesis_phase", plan.synthesis_phase),
            ("czt", lambda: plan.tables.chirp(
                "uniform", plan.n_host, plan.nm, plan.P, plan.L, +1,
                plan.cdtype)),
            ("rings_to_map", lambda: plan.rings_to_map(
                torch.zeros((plan.nrings_pad, plan.P), device=plan.device)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        build[name] = time.perf_counter() - t0
    Y = Q * plan.synthesis_phase()
    X = czt_blocked(Y, plan.n_host, plan.P, plan.L, +1, plan.cdtype,
                    plan.ring_block, plan.tables, "uniform", real=True)
    ms = dict(phase=cuda_ms(lambda: Q * plan.synthesis_phase(), reps),
              ffts=cuda_ms(lambda: czt_blocked(
                  Y, plan.n_host, plan.P, plan.L, +1, plan.cdtype,
                  plan.ring_block, plan.tables, "uniform", real=True), reps),
              rings_to_map=cuda_ms(lambda: plan.rings_to_map(X), reps))
    del X, Y
    return build, ms


def analysis_v2_vs_uniform(plan, maps):
    """The bucketed (v2) analysis ring stage against the uniform one on the
    same map, on the columns both compute (v2 leaves the cap columns beyond
    each group's turning-point cutoff at 0): (relative distance, v2 ms,
    uniform ms), CUDA events, mean of 3 after a warm-up."""
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.tools import cuda_ms

    plan.use_rings_v2 = False
    Gu = T.analysis_rings(plan, maps)
    u_ms = cuda_ms(lambda: T.analysis_rings(plan, maps), 3)
    plan.use_rings_v2 = True
    Gv = T.analysis_rings(plan, maps)
    v_ms = cuda_ms(lambda: T.analysis_rings(plan, maps), 3)
    for b in plan.ring_stage().abuckets:
        Gu[..., b["rows"], b["K"]:] = 0
    err = rel_err(Gv, Gu)
    del Gu, Gv
    return err, v_ms, u_ms


def ring_stage_phase(dev):
    """The synthesis ring stages at order 12 on K2's streams: each mode
    timed (CUDA events), its first call (tables built), peak memory and
    table bytes, its maps within RING_BOUND of the uniform mode's; the
    uniform mode split; the v2 analysis against the uniform analysis; at
    order 10 every mode against a float64 uniform run of the same streams.
    Returns the order-12 numbers by mode and the order-10 distances."""
    import torch
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.plan import SHTPlan

    res = {}
    for order in RING_ORDERS:
        plan, alm, _, _ = band_limited_inputs(order, dev, order)
        Q = ring_streams(plan, alm)
        del alm
        torch.cuda.empty_cache()
        modes = ring_stage_modes(plan, Q)
        ref = modes["uniform"]["maps"]
        if order == RING_ORDERS[1]:
            p64 = SHTPlan(order, dev, dtype=torch.float64)
            p64.synthesis_rings_mode = "uniform"
            ref = T.synthesis_rings(p64, Q.to(torch.complex128))
            del p64
        dist = {}
        for mode, r in modes.items():
            dist[mode] = rel_err(r["maps"].double(), ref.double())
            check(dist[mode] < RING_BOUND, f"ring stage {mode} at order "
                  f"{order}: {dist[mode]:.3e} from the reference")
        res[order] = dict(modes=modes, dist=dist)
        if order == RING_ORDERS[0]:
            res["split"] = uniform_split(plan, Q)
            res["analysis"] = analysis_v2_vs_uniform(plan,
                                                     modes["v2"]["maps"][0])
            check(res["analysis"][0] < RING_BOUND, f"v2 analysis off the "
                  f"uniform analysis: {res['analysis'][0]:.3e}")
        for r in modes.values():
            del r["maps"]
        del Q, ref, modes, plan
        torch.cuda.empty_cache()
    return res


def report_ring_stages(rings, default):
    """Print phase 9's numbers; fail unless the port's default synthesis
    ring stage is the fastest at the first of RING_ORDERS (within
    RING_DEFAULT_SLACK)."""
    o12, o10 = RING_ORDERS
    for mode, r in rings[o12]["modes"].items():
        say(f"order {o12} synthesis ring stage {mode} on 2 streams: "
            f"{r['ms']:.3f} ms (first call, tables built: "
            f"{r['first_s']:.3f} s), peak {r['peak_gib']:.2f} GiB above its "
            f"inputs, tables {r['table_bytes']} bytes; "
            f"{rings[o12]['dist'][mode]:.3e} of max from uniform (bound "
            f"{RING_BOUND:g})")
    for mode, d in rings[o10]["dist"].items():
        say(f"order {o10} synthesis ring stage {mode}: {d:.3e} of max from "
            f"a float64 uniform run of the same streams (bound "
            f"{RING_BOUND:g}); {rings[o10]['modes'][mode]['ms']:.3f} ms")
    build, parts = rings["split"]
    say(f"order {o12} uniform synthesis split: table builds "
        + ", ".join(f"{k} {v:.3f} s" for k, v in build.items())
        + "; per call " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in parts.items()))
    err, v_ms, u_ms = rings["analysis"]
    say(f"order {o12} analysis ring stage v2 vs uniform on the columns both "
        f"compute: {err:.3e} of max (bound {RING_BOUND:g}); v2 {v_ms:.3f} "
        f"ms, uniform {u_ms:.3f} ms")
    ring_ms = {m: r["ms"] for m, r in rings[o12]["modes"].items()}
    fastest = min(ring_ms, key=ring_ms.get)
    say(f"synthesis ring stages at order {o12}: fastest {fastest}, the "
        f"port's default {default}")
    check(ring_ms[default]
          <= (1.0 + RING_DEFAULT_SLACK) * ring_ms[fastest],
          f"the default synthesis ring stage {default} "
          f"is not the fastest: {ring_ms}")


def grouped_row_err(got, ref):
    """Max over packed rows of |got - ref| / max|ref| of the row's quantity
    (n, beta, A, Aprev, alpha, U, phi)."""
    groups = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))
    worst = 0.0
    for a, b in groups:
        scale = float(ref[a:b].abs().max()) or 1.0
        worst = max(worst, float((got[a:b] - ref[a:b]).abs().max()) / scale)
    return worst


def seeded_particles(n, radius, seed):
    """n particles of 1e12 Msun/h in random directions at one radius."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius, np.full(n, 1.0e12)


def pixel_centre_particles(cfg, cosmo, plane, n, seed):
    """n particles at the centres of random SHTOrder pixels of a plane,
    their total mass that of the plane's mean background density (so the
    scaled density map has the density contrast of a lightcone shell, not a
    monopole 300x its fluctuations).  At pixel centres the NGP pixel of a
    particle cannot flip between two evaluations that round differently;
    a flip moves a particle's whole mass to a neighbour pixel."""
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.healpix import core as hp

    pp = plane_params(cfg, cosmo, plane)
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 12 * 4**cfg.SHTOrder, size=n)
    pos = hp.pix2vec_ring(pix, cfg.SHTOrder) * pp.rad
    return pos, np.full(n, pp.backdens * 4.0 * np.pi / pp.densfact / n)


# the driver's phase row of a Profile'd plane step
PROFILE_TAGS = ("DEPOSIT", "SHTSOLVE", "SHT", "RAYPROP")
# the planes of each CUDA-vs-CPU trace at SHTOrder 7 / rayOrder 6 (phases 4
# and 11)
TRACE_PLANES = 2
# the kernels each pair of selectors runs on the plane step
PATH_KERNELS = {("k2", "k1"): ("legendre_synth", "legendre_analysis"),
                ("k3", "k4"): ("legendre_synth_vpu", "legendre_analysis_dot",
                               "legendre_chain_seed")}


def trace_cuda_vs_cpu(synth, analysis, rings_mode):
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=7, rayOrder=6, bundleOrder=3,
                         Precision="f32").finalize()
    cpu = Raytracer(cfg, device="cpu")
    gpu = Raytracer(cfg, device="cuda")
    for rt in (cpu, gpu):
        rt.plan.synth_kernel, rt.plan.analysis_kernel = synth, analysis
        rt.plan.synthesis_rings_mode = rings_mode
        rt.init_rays()
    _ext.reset_launches()
    errs = []
    for p in range(TRACE_PLANES):
        pos, mass = pixel_centre_particles(cfg, cpu.cosmo, p, 20000, 100 + p)
        cpu.step(p, pos=pos, mass=mass)
        gpu.step(p, pos=pos, mass=mass)
        errs.append(grouped_row_err(gpu.rays_packed.cpu(), cpu.rays_packed))
    counts = dict(_ext.launches)
    check(all(counts[k] >= TRACE_PLANES
              for k in PATH_KERNELS[(synth, analysis)]),
          f"CUDA trace ({synth}, {analysis}) did not launch its kernels: "
          f"{counts}")
    check(bool(torch.isfinite(gpu.rays_packed).all()), "non-finite rays")
    return errs, counts


def traced_run(device, out_dir, map_planes, dtype=None, **extra):
    """Raytracer.run, the entry point a user calls, at the trace's shape
    (SHTOrder 7 / rayOrder 6, f32, 8 planes) with MapRedshiftList naming
    `map_planes` and OutputPath `out_dir`: the driver's own map-plane logic
    writes the lens maps at LensMapOrder 4; extra goes on the
    configuration, dtype (None: float32) on the Raytracer.  Each plane's
    particles come
    from pixel_centre_particles through load_particles (the card's machine
    has no h5py for lens-plane files).  Returns (Raytracer, launches)."""
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch import maps as tmaps
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8)
    # redshifts at the comoving distances of the map planes
    zgrid = np.linspace(0.0, 3.0, 30001)
    binL = base["maxComvDistance"] / base["NumLensPlanes"]
    zs = np.interp(np.asarray(map_planes) * binL,
                   tmaps.comoving_distance_2f1(zgrid, base["OmegaM"]), zgrid)
    zpath = f"{out_dir}/map_redshifts.txt"
    with open(zpath, "w") as fp:
        fp.write("".join(f"{z:.10f}\n" for z in zs))
    cfg = RayTraceConfig(SHTOrder=7, rayOrder=6, bundleOrder=3,
                         Precision="f32", MapRedshiftList=zpath,
                         LensMapOrder=4,
                         OutputPath=f"{out_dir}/{device}-{dtype}",
                         **base, **extra).finalize()
    rt = Raytracer(cfg, device=device, dtype=dtype)
    check(sorted(rt._map_planes()) == sorted(map_planes),
          f"map redshifts {zs} give planes {rt._map_planes()}")
    rt.load_particles = lambda p: pixel_centre_particles(cfg, rt.cosmo, p,
                                                         20000, 100 + p)
    _ext.reset_launches()
    rt.run(progress=False)
    return rt, dict(_ext.launches)


def run_with_maps():
    """traced_run on the CPU (twins) and on the card (kernels), with lens
    maps after planes 1 and 2 (the planes that the trace above compares):
    each run writes both files per map plane and counts its map planes;
    the card's files agree with the CPU's as the rays do (pixel ids and
    ray counts exact; the per-pixel means of A, of ra and of dec, and the
    convergence, within TRACE_BOUND of the largest |value| of A, ra and
    dec).  Returns (worst error, card launches)."""
    import os
    import tempfile

    from calclens_tpu_torch.io import fits

    map_planes = (1, 2)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {dev: traced_run(dev, tmp, map_planes)
                for dev in ("cpu", "cuda")}
        counts = runs["cuda"][1]
        check(all(counts[k] >= 8 for k in PATH_KERNELS[("k2", "k1")]),
              f"Raytracer.run on the card did not launch its kernels: "
              f"{counts}")
        worst = 0.0
        for i in range(len(map_planes)):
            tabs = {}
            for dev, (rt, _) in runs.items():
                check(rt.map_num == len(map_planes), f"{dev} run wrote "
                      f"{rt.map_num} map planes")
                cpath, rpath = (os.path.join(rt.cfg.OutputPath,
                                             f"{kind}_16_{i}.fits")
                                for kind in ("Convergence", "Rays"))
                check(os.path.exists(cpath) and os.path.exists(rpath),
                      f"{dev} run did not write the lens maps of map {i}")
                tabs[dev] = (fits.read_fits(cpath)[1][1],
                             fits.read_fits(rpath)[1][1])
            (cg, rg), (cc, rc) = tabs["cuda"], tabs["cpu"]
            check(np.array_equal(rg["N_RAYS"], rc["N_RAYS"])
                  and np.array_equal(rg["NEST_IDX"], rc["NEST_IDX"]),
                  f"map {i}: pixel ids or ray counts differ")
            amax = max(float(np.abs(rc[k]).max())
                       for k in ("A00", "A01", "A10", "A11"))
            for k, scale in (("A00", amax), ("A01", amax), ("A10", amax),
                             ("A11", amax), ("SIGNAL", amax),
                             ("ra", float(np.abs(rc["ra"]).max())),
                             ("dec", float(np.abs(rc["dec"]).max()))):
                g, c = (cg, cc) if k == "SIGNAL" else (rg, rc)
                worst = max(worst, float(np.abs(
                    g[k].astype(np.float64) - c[k]).max()) / scale)
    check(worst < TRACE_BOUND, f"Raytracer.run lens maps, card vs CPU: "
          f"{worst:.3e}")
    return worst, counts


def headline(synth, analysis, planes, snapshot_after, maps_order=None,
             profile_plane=None, compare_mode=None, repeat=False, **cfg_kw):
    """The plane step at the headline shape with the given kernels (and
    cfg_kw on top of the headline configuration: another deposit, a sky
    box): plane 1 as warm-up, then `planes` timed; the launch counts of
    exactly those planes, and of each plane apart, peak device memory, and
    a host copy of the rays after plane `snapshot_after`; then, with
    maps_order, the lens maps of the final rays (lens_maps); with
    profile_plane, that plane once more with Profile set (the driver's
    phase row: DEPOSIT, SHTSOLVE, SHT, RAYPROP); with compare_mode, the
    synthesis ring stage switched to that mode, one plane to build its
    tables and one timed plane.  With repeat (before the Profile'd and the
    compared planes), the plane's deposit twice on the same particles
    (deposit_twice) and one plane twice from the same rays
    (repeat_plane, with the lens maps at MAP_ORDER), each pair equal bit
    for bit.  SPH's per-bucket windows are built (and timed) before the
    warm-up plane; a box's setup includes its vacuum mask and ray
    pixels."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.poisson import sph_windows

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=12, rayOrder=10, bundleOrder=3,
                         Precision="f32", **cfg_kw).finalize()
    gc.collect()  # an earlier phase's Raytracer must not count in the peak
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device="cuda")
    rt.plan.synth_kernel, rt.plan.analysis_kernel = synth, analysis
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    windows_s = None
    if rt.sph is not None:
        t0 = time.perf_counter()
        sph_windows(rt.plan, rt.sph[:-3])
        torch.cuda.synchronize()
        windows_s = time.perf_counter() - t0
    nrays = rt.rays_packed.shape[1]
    npart = 1 << 21
    pos, mass = seeded_particles(npart, 1.0, 12)
    extra = planes[-1] + 1
    staged = {p: rt.stage_particles(pos * (250.0 * p + 125.0), mass)
              for p in (1, *planes, extra)}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    plane_counts = []

    def counted_step(p):
        before = dict(_ext.launches)
        rt.step(p, *staged[p])  # ends in torch.cuda.synchronize()
        plane_counts.append({k: v - before[k]
                             for k, v in _ext.launches.items()})

    counted_step(1)  # warm-up plane
    times = []
    snap = None
    for p in planes:
        t = time.perf_counter()
        counted_step(p)
        times.append(time.perf_counter() - t)
        if p == snapshot_after:
            snap = rt.rays_packed.cpu()
    counts = dict(_ext.launches)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(rt.rays_packed).all())
    check(finite, f"headline ({synth}, {analysis}): non-finite ray rows")
    ran = PATH_KERNELS[(synth, analysis)]
    check(all(counts[k] > 0 for k in ran) and
          all(v == 0 for k, v in counts.items() if k not in ran),
          f"headline ({synth}, {analysis}): launches {counts}, expected "
          f"only {ran}")
    out = dict(setup_s=setup_s, times=times, nrays=nrays, npart=npart,
               counts=counts, peak=peak, shape=tuple(rt.rays_packed.shape),
               snap=snap, mode=rt.plan.synthesis_rings_mode,
               order=cfg.SHTOrder,
               plane_counts=plane_counts, windows_s=windows_s,
               resident=resident,
               masked=(None if rt.vacmask is None
                       else int(rt.vacmask.sum())))
    if maps_order is not None:
        out["maps"] = lens_maps(rt, maps_order)
    if repeat:
        label = f"headline ({synth}, {analysis}, {rt.cfg.DepositScheme})"
        equal, ms = deposit_twice(rt, extra, staged[extra])
        check(equal, f"{label}: two deposits of one plane differ")
        out["deposit_twice"] = ms
        rep = out["repeat"] = repeat_plane(rt, extra, staged[extra], MAP_ORDER)
        check(rep["equal"] and rep["maps_equal"], f"{label}: plane {extra} "
              f"twice from the same rays differs: {rep}")
    if profile_plane is not None:
        rt.cfg.Profile = True
        rt.step(profile_plane, *staged[extra])
        rt.cfg.Profile = False
        row = dict(rt.phase_rows)[profile_plane]
        check(sorted(row) == sorted(PROFILE_TAGS) and
              sum(row.values()) <= rt.timings[-1][1],
              f"Profile'd plane: phase row {row}, step {rt.timings[-1]}")
        out["profile"] = (rt.timings[-1][1], row)
    if compare_mode is not None:
        rt.plan.synthesis_rings_mode = compare_mode
        rt.step(planes[0], *staged[planes[0]])  # builds its tables
        t = time.perf_counter()
        rt.step(extra, *staged[extra])
        out["compare"] = (compare_mode, time.perf_counter() - t)
        check(bool(torch.isfinite(rt.rays_packed).all()),
              f"headline with {compare_mode}: non-finite ray rows")
    return out


def lens_maps(rt, order):
    """The driver's lens maps of the current rays at `order`, written to a
    temporary directory: the card's [7, npix] sums against a float64 host
    accumulation of the same ray buffer (scatter-add onto each ray's NEST
    pixel >> 2k: ring2nest of its index on the full sky, a box's ray_nest);
    counts exact, the other rows within MAP_BOUND of each row's max; both
    FITS files read back.  Returns (worst row error, seconds of the driver's
    map writer, pixels)."""
    import tempfile

    import torch
    from calclens_tpu_torch import maps as tmaps
    from calclens_tpu_torch.healpix import core as hp
    from calclens_tpu_torch.io import fits

    ray_order = rt.cfg.rayOrder
    got = tmaps.accum_lens_map_packed(rt.rays_packed, rt._ray_nest,
                                      ray_order, order).cpu().double().numpy()
    packed = rt.rays_packed.cpu().double().numpy()
    nx, ny, nz = packed[0], packed[1], packed[2]
    theta = np.arccos(np.clip(nz / np.sqrt(nx * nx + ny * ny + nz * nz),
                              -1.0, 1.0))
    phi = np.arctan2(ny, nx)
    phi = np.where(phi < 0.0, phi + 2.0 * np.pi, phi)
    vals = (np.ones_like(nx), packed[6], packed[7], packed[8], packed[9],
            np.degrees(phi), 90.0 - np.degrees(theta))
    npix = int(hp.order2npix(order))
    nest = (hp.ring2nest(np.arange(packed.shape[1]), ray_order)
            if rt._ray_nest is None else rt._ray_nest)
    lpix = nest >> (2 * (ray_order - order))
    del packed
    ref = np.stack([np.bincount(lpix, weights=v, minlength=npix)
                    for v in vals])
    check(np.array_equal(got[0], ref[0]), "lens map: counts differ from the "
          "host accumulation")
    err = max(float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
              for k in range(1, 7))
    check(err < MAP_BOUND, f"lens map off the float64 host sums: {err:.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        rt.cfg.OutputPath, rt.cfg.LensMapOrder = tmp, order
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpath, rpath = rt._write_map_outputs()
        write_s = time.perf_counter() - t0
        sig = fits.read_fits(cpath)[1][1]["SIGNAL"]
        rec = fits.read_fits(rpath)[1][1]
        check(len(sig) == npix and len(rec) == npix
              and np.array_equal(rec["N_RAYS"], ref[0].astype(np.int32))
              and bool(np.isfinite(sig).all()),
              "lens map FITS files do not read back")
    return err, write_s, npix


def check_probe(mode, shape, got, ref, errs):
    """One probe output against its plain version; errs[mode] keeps the
    largest absolute error."""
    import torch

    check(bool(torch.isfinite(ref).all()), f"probe {mode}: plain values "
          f"not finite at {shape}")
    rel = rel_err(got, ref)
    err = float((got - ref).abs().max())
    bound = PROBE_DOT_BOUND if mode == "dot" else PROBE_BOUND
    say(f"P1 roofline_probe {mode} at {shape}: rel {rel:.3e} abs {err:.3e} "
        f"(bound {bound:g})")
    check(rel <= bound, f"probe {mode} off its plain version at {shape}: "
          f"{rel:.3e}")
    errs[mode] = max(errs.get(mode, 0.0), err)


def probe_phase(dev, kernel_ms, plan):
    """P1: every mode against its plain version at PROBE_CHECKS; then the
    tool's ceilings() at its default shape (the path whose launches are
    counted), each mode's plain version and, for dot, torch.bmm timed on
    the same inputs, store and dot held to their plain versions there (the
    recurrence overflows at that shape); the Legendre kernels' shares of
    the rec and rec+store ceilings from their order-12 times `kernel_ms`
    and the tool's element counts; the SASS check that the rec+store loop
    keeps its stores."""
    from calclens_tpu_torch.tools import cuda_ms
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.tools import roofline_legendre as R

    errs = {}
    for shape in PROBE_CHECKS:
        geo = R.default_geo(shape["TJ"], dev)
        for mode in R.MODES:
            check_probe(mode, shape, R.probe_cuda(geo=geo, mode=mode, **shape),
                        R.probe_plain(geo=geo, mode=mode, **shape), errs)
    _ext.reset_launches()
    ceil = R.ceilings(dev)
    launches = _ext.launches["roofline_probe"]
    check(launches > 0 and sum(_ext.launches.values()) == launches,
          f"ceilings() launches {dict(_ext.launches)}")
    sh = R.DEFAULT_SHAPE
    geo = R.default_geo(sh["TJ"], dev)
    plain_ms = {}
    for mode in R.MODES:
        ref, plain_ms[mode] = timed_once(
            lambda m=mode: R.probe_plain(geo=geo, mode=m, **sh))
        if mode in ("store", "dot"):
            check_probe(mode, dict(sh), R.probe_cuda(geo=geo, mode=mode, **sh),
                        ref, errs)
        del ref
    lib_ms = cuda_ms(lambda: R.dot_library(geo=geo, **sh), 3)
    lib_err = rel_err(R.dot_library(geo=geo, **sh),
                      R.probe_plain(geo=geo, mode="dot", **sh))
    say(f"P1 dot: torch.bmm (FP32) {lib_ms:.3f} ms, rel {lib_err:.3e} from "
        f"the plain version; plain ms per mode {plain_ms}")
    elems = R.elements(**sh)
    rows = sh["MT"] * sh["TM"]
    out_bytes = {m: 4.0 * rows * sh["TJ"] * (R.DOT_COLS if m == "dot" else 1)
                 + 4.0 * 5 * sh["TJ"] for m in R.MODES}
    smem_peak = R.smem_peak_bytes_per_s()
    check(smem_peak, "nvidia-smi gave no SM clock for the shared-memory peak")
    modes = {}
    for mode in R.MODES:
        # the store modes also write 4 bytes per element into shared memory;
        # rec's 4 rounded operations take 4 issue slots per element
        limits = {"operations": elems * R.FLOPS[mode] / FP32_PEAK,
                  "bytes": out_bytes[mode] / HBM_RATE,
                  "shared memory": (4.0 * elems / smem_peak
                                    if "store" in mode else 0.0),
                  "issue slots": elems * R.SLOTS.get(mode, 0) / SLOT_RATE}
        by = max(limits, key=limits.get)
        modes[mode] = dict(
            ms=ceil[mode]["ms"], plain_ms=plain_ms[mode],
            bound_ms=1e3 * limits[by], bound_by=by,
            flop_bound_ms=1e3 * limits["operations"],
            library_ms=lib_ms if mode == "dot" else None,
            max_abs_err=errs[mode])
        say(f"P1 {mode}: {ceil[mode]['ms']:.4f} ms, bound "
            f"{modes[mode]['bound_ms']:.4f} ms ({modes[mode]['bound_by']}); "
            f"FLOP-counted {modes[mode]['flop_bound_ms']:.4f} ms")
    counts = R.element_counts(plan)
    sh_ = R.shares(kernel_ms, counts, ceil)
    for name, (rate, s_rec, s_rs) in sh_.items():
        say(f"order 12 {name}: {kernel_ms[name]:.2f} ms, {counts[name]:.4e} "
            f"elements, {rate:.1f} G elem/s = {s_rec:.1%} of the rec "
            f"ceiling, {s_rs:.1%} of rec+store")
    st = R.store_loop_check()
    fadd = st["ops"].get("FADD", 0)
    say(f"P1 rec+store loop SASS (cuobjdump): {st['stored_floats']} floats "
        f"stored per {fadd} FADD; {st['ops']}")
    check(st["stored_floats"] >= fadd > 0,
          f"rec+store loop lost its stores: {st}")
    rec_loop = R.rec_loop_sass()
    say(f"P1 rec loop SASS (cuobjdump): {rec_loop['group']} instructions per "
        f"group of {R.PROBE_GROUP} degrees, {rec_loop['per_element']:.3f} per "
        f"element (floor {R.SLOTS['rec']}); {rec_loop['ops']}")
    steady = R.steady_loop_sass()
    for name, r in steady.items():
        say(f"{name} steady loop SASS (cuobjdump): {r['group']} instructions "
            f"per group, {r['per_degree']:.3f} per degree and thread, "
            f"{r['per_element']:.3f} per element, "
            f"{r['cuda_core_per_element']:.3f} without HMMA (floor "
            f"{SLOTS_PER_ELEMENT[name]}; P1 rec "
            f"{rec_loop['per_element']:.3f}); {r['ops']}")
    check(sorted(steady) == sorted(R.STEADY_KERNELS[k][0]
                                   for k in R.STEADY_KERNELS),
          f"steady loops not found in the SASS: {sorted(steady)}")
    return dict(launches=launches, modes=modes, shares=sh_, shape=dict(sh),
                steady=steady, rec_loop=rec_loop)


def gather_phase(dev):
    """P2-P4 through the tool's run() at N = 2^23 (the path whose launches
    are counted): each bit-exact against tab[idx], timed beside it."""
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.tools import exp_gather as G

    _ext.reset_launches()
    res = G.run(dev)
    counts = dict(_ext.launches)
    for name, r in res.items():
        check(r["exact"], f"{name} differs from tab[idx]: max abs "
              f"{r['max_abs_err']:.3e}")
        check(counts[name] > 0, f"{name} was not launched: {counts}")
        r["launches"] = counts[name]
        say(f"{name}: {r['ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of its {r['bound_ms']:.4f} ms bound ({r['bound_by']}), "
            f"bit-exact")
    route = G.onehot_route_sass()
    say(f"P4 gather_onehot SASS (cuobjdump): {route}")
    check(route["HGMMA"] > 0 and route["HMMA"] == 0,
          f"gather_onehot does not run on wgmma alone: {route}")
    res["gather_onehot"]["sass"] = route
    return res


def report_headline(label, h):
    per_plane = float(np.median(h["times"]))
    say(f"{label} SHTOrder 12 / rayOrder 10 / 2^21 particles f32, "
        f"synthesis ring stage {h['mode']}: "
        f"planes {', '.join(f'{t:.4f}' for t in h['times'])} s, "
        f"median {per_plane:.4f} s/plane, {h['nrays'] / per_plane:.0f} "
        f"rays/s, peak {h['peak'] / 2**30:.2f} GiB ({h['resident'] / 2**30:.2f} "
        f"GiB resident before the planes), setup "
        f"{h['setup_s']:.2f} s, launches {h['counts']}, rays {h['shape']} "
        f"finite")
    if "profile" in h:
        step, row = h["profile"]
        say(f"{label} Profile'd plane: step {step:.4f} s; "
            + ", ".join(f"{k} {row[k]:.4f} s" for k in PROFILE_TAGS))
    if "compare" in h:
        mode, t = h["compare"]
        say(f"{label} with synthesis ring stage {mode}: one timed plane "
            f"{t:.4f} s against {h['mode']}'s median {per_plane:.4f} s")
    if "repeat" in h:
        dep = ", ".join(f"{t:.2f}" for t in h["deposit_twice"])
        steps = ", ".join(f"{t:.4f}" for t in h["repeat"]["s"])
        say(f"{label} twice: one plane's deposit ({dep} ms) equal bit for "
            f"bit; one plane from the same rays ({steps} s): rays and "
            f"order-{MAP_ORDER} lens maps equal bit for bit")


# the octant box of the cut-sky headline (the footprint of octant mock
# lightcones) and the 40 x 40 degree box of its order-7 trace
OCTANT = dict(minRa=0.0, maxRa=90.0, minDec=0.0, maxDec=90.0)
TRACE_BOX = dict(minRa=20.0, maxRa=60.0, minDec=-10.0, maxDec=30.0)
# K1 and K2 launches per plane step: one analysis and one synthesis, eight
# analyses (one per sigma bucket) for SPH
def stream_blocks(order):
    """The default j-blocks of the synthesis at SHTOrder `order`."""
    import types

    from calclens_tpu_torch.sht import transforms as T

    return T.synth_stream_blocks(types.SimpleNamespace(order=order))


# launches per plane; legendre_synth's is replaced by the order's j-blocks
PLANE_LAUNCHES = {"NGP": {"legendre_analysis": 1, "legendre_synth": 1},
                  "CIC": {"legendre_analysis": 1, "legendre_synth": 1},
                  "SPH": {"legendre_analysis": 8, "legendre_synth": 1},
                  # the MG step (any deposit: SPH deposits its SHT map by
                  # NGP): one analysis, one potential-only synthesis
                  "MG": {"legendre_analysis": 1, "legendre_synth_phi": 1}}


def check_plane_launches(label, plane_counts, scheme, order=None):
    """Every plane of the run launched exactly PLANE_LAUNCHES[scheme] and
    nothing else, K2 once per j-block of the synthesis at SHTOrder `order`
    (transforms.synth_stream_blocks: 1 below order 13)."""
    want = dict(PLANE_LAUNCHES[scheme])
    if "legendre_synth" in want:
        want["legendre_synth"] = stream_blocks(order)
    for i, c in enumerate(plane_counts):
        got = {k: v for k, v in c.items() if v}
        check(got == want, f"{label}: plane {i} launched {got}, expected "
              f"{want}")


def legendre_route_seconds(lmax):
    """Host seconds of one kernel_bl window at lmax by the JAX package's
    route (scipy's eval_legendre per degree, whose cost grows with the
    degree) and by the port's single recurrence (ops/deposit.py), which
    give the same values."""
    from scipy.special import eval_legendre

    from calclens_tpu_torch.ops import deposit as dep

    sigma = 0.01
    g = np.linspace(0.0, sigma, 513)
    x = np.cos(g)
    w = np.gradient(g) * np.sin(g) * np.maximum(1.0 - (g / sigma) ** 2, 0.0)
    t0 = time.perf_counter()
    ref = eval_legendre(np.arange(lmax + 1)[:, None], x[None, :]) @ w
    scipy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = dep.kernel_bl(sigma, lmax)
    port_s = time.perf_counter() - t0
    check(np.array_equal(got, ref / ref[0]), "kernel_bl off the scipy route")
    return scipy_s, port_s


def mass_map_plane(snap, plane):
    """One UseHEALPixLensPlaneMaps plane at the headline shape from the
    headline's rays `snap`, its map the NGP counts of the headline
    particles (partMass 1e12, as each particle's mass) written as a <f4
    file in a temporary directory; then the same plane from the same rays
    twice through the particle path.  The mass-map plane's scaled density
    (load_mass_map, then scale_density, as its DEPOSIT phase) must equal
    the particle path's (phase_deposit) bit for bit: counts x 100 and sums
    of 100.0 are exact in float32.  Downstream the two planes run the same
    code, which sums in a fixed order (K1's ring tiles, the deposits), so
    the particle plane run twice gives the same rays bit for bit, and the
    mass-map plane's rays equal them bit for bit.  Returns (distances
    {quantity: (mass-map vs particle, particle vs particle)}, all 0,
    mass-map step seconds, its phase row, its launches, counts' write
    seconds)."""
    import tempfile

    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer, plane_params
    from calclens_tpu_torch.healpix import torchhp
    from calclens_tpu_torch.io import healpix_maps
    from calclens_tpu_torch.ops.deposit import scale_density
    from calclens_tpu_torch.poisson import phase_deposit, plane_scalars

    pos, mass = seeded_particles(1 << 21, 250.0 * plane + 125.0, 12)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0,
                             NumLensPlanes=8, SHTOrder=12, rayOrder=10,
                             bundleOrder=3, Precision="f32", partMass=1e12,
                             HEALPixLensPlaneMapPath=tmp,
                             HEALPixLensPlaneMapName="massmap",
                             HEALPixLensPlaneMapOrder=12).finalize()
        check(cfg.UseHEALPixLensPlaneMaps, "mass-map configuration")
        rt = Raytracer(cfg, device="cuda")
        # the particle path's own float32 positions, so that no particle
        # lands in another pixel than it does there
        pos_d, mass_d = rt.stage_particles(pos, mass)
        pix = torchhp.vec2pix_ring(pos_d[:len(pos)], rt.plan.order)
        # sums of 1.0, exact in float32 in any order
        counts = torch.zeros(rt.plan.npix, dtype=torch.float32,
                             device=rt.device).index_add_(
            0, pix, torch.ones(len(pix), device=rt.device))
        t0 = time.perf_counter()
        healpix_maps.write_plane_map(tmp, "massmap", plane,
                                     counts.cpu().numpy())
        write_s = time.perf_counter() - t0
        del counts, pix
        scal = plane_scalars(plane_params(cfg, rt.cosmo, plane), rt.dtype,
                             rt.device)
        dens_map = scale_density(rt.load_mass_map(plane), scal.densfact,
                                 scal.backdens, 4.0 * math.pi / rt.plan.npix)
        dens_part = phase_deposit(rt.plan, rt.tab, pos_d, mass_d, "NGP",
                                  scal)
        check(torch.equal(dens_map, dens_part), "mass-map density differs "
              "from the particle deposit's")
        del dens_map, dens_part, pos_d, mass_d
        rt.cfg.Profile = True
        rt.load_state(snap, plane)
        _ext.reset_launches()
        rt.step(plane)
        launches = dict(_ext.launches)
        step_s, row = rt.timings[-1][1], dict(rt.phase_rows)[plane]
        got = rt.rays_packed.cpu()
    rt.cfg.Profile = False
    rt.cfg.UseHEALPixLensPlaneMaps = False
    refs = []
    for _ in range(2):
        rt.load_state(snap, plane)
        rt.step(plane, pos=pos, mass=mass)
        refs.append(rt.rays_packed.cpu())
    check_plane_launches("mass-map plane", [launches], "NGP", 12)

    def dist(x, y, a, b):
        return float((x[a:b] - y[a:b]).abs().max() / y[a:b].abs().max())

    dists = {q: (dist(got, refs[0], a, b), dist(refs[1], refs[0], a, b))
             for q, a, b in (("alpha", 14, 16), ("U", 16, 20),
                             ("phi", 20, 21))}
    check(torch.equal(refs[1], refs[0]),
          f"the particle plane run twice differs: {dists}")
    check(torch.equal(got, refs[0]) and bool(torch.isfinite(got).all()),
          f"mass-map plane vs particle plane: {dists}")
    return dists, step_s, row, launches, write_s


def trace_path(label, cfg_kw, mass_maps=False):
    """A CUDA-vs-CPU trace of TRACE_PLANES at SHTOrder 7 / rayOrder 6, f32, with
    cfg_kw on the trace configuration: each plane's particles at pixel
    centres, or (mass_maps) their mass per pixel / partMass written as the
    plane's <f4 map; the packed rays within TRACE_BOUND of each quantity's
    max after every plane, the same ray pixels on both devices, the card's
    launches exactly PLANE_LAUNCHES per plane.  Returns (errors per plane,
    rays, vacuum-mask pixels that differ between CPU and card)."""
    import tempfile

    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.healpix import core as hp
    from calclens_tpu_torch.io import healpix_maps

    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                SHTOrder=7, rayOrder=6, bundleOrder=3, Precision="f32")
    with tempfile.TemporaryDirectory() as tmp:
        if mass_maps:
            cfg_kw = dict(cfg_kw, partMass=1e12, HEALPixLensPlaneMapPath=tmp,
                          HEALPixLensPlaneMapName="massmap",
                          HEALPixLensPlaneMapOrder=7)
        cfg = RayTraceConfig(**base, **cfg_kw).finalize()
        cpu = Raytracer(cfg, device="cpu")
        gpu = Raytracer(cfg, device="cuda")
        for rt in (cpu, gpu):
            rt.init_rays()
        check(np.array_equal(cpu.ray_nest, gpu.ray_nest),
              f"trace {label}: ray pixels differ")
        vac_diff = (0 if cpu.vacmask is None else
                    int((cpu.vacmask != gpu.vacmask.cpu()).sum()))
        errs, plane_counts = [], []
        for p in range(TRACE_PLANES):
            pos, mass = pixel_centre_particles(cfg, cpu.cosmo, p, 20000,
                                               100 + p)
            if mass_maps:
                pix = hp.ang2pix_ring(*hp.vec2ang(pos), cpu.plan.order)
                healpix_maps.write_plane_map(
                    tmp, "massmap", p,
                    np.bincount(pix, mass / 1e12, minlength=cpu.plan.npix))
                pos = mass = None
            cpu.step(p, pos=pos, mass=mass)
            before = dict(_ext.launches)
            gpu.step(p, pos=pos, mass=mass)
            plane_counts.append({k: v - before[k]
                                 for k, v in _ext.launches.items()})
            errs.append(grouped_row_err(gpu.rays_packed.cpu(),
                                        cpu.rays_packed))
    check_plane_launches(f"trace {label}", plane_counts,
                         cfg.DepositScheme, cfg.SHTOrder)
    check(max(errs) < TRACE_BOUND, f"trace {label}, CUDA vs CPU: {errs}")
    return errs, gpu.rays_packed.shape[1], vac_diff


def report_headline_path(label, h, scheme):
    """Phase 10's lines for one headline path (SPH, cut-sky CIC): the
    plane launches checked, then report_headline's lines and the rest."""
    check_plane_launches(label, h["plane_counts"], scheme, h["order"])
    report_headline(label, h)
    if h["masked"] is not None:
        say(f"{label}: {h['nrays']} rays in the box, {h['masked']} of "
            f"{12 * 4**12} SHT pixels masked as vacuum")
    if h["windows_s"] is not None:
        say(f"{label}: per-bucket windows (8 kernel_bl / pixwin^2, lmax "
            f"12287) built once in {h['windows_s']:.3f} s of host time")
    say(f"{label}: launches per plane (warm-up, timed): "
        + "; ".join(str({k: v for k, v in c.items() if v})
                    for c in h["plane_counts"]))


def write_catalog(stem, n, seed, rmin, rmax):
    """n sources in random directions at radii uniform in [rmin, rmax],
    written by the port's write_source_gals as <stem>.fit and listed in
    <stem>.txt.  Returns (list path, positions)."""
    from calclens_tpu_torch.gals import io as galsio

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * rng.uniform(rmin, rmax, (n, 1))
    galsio.write_source_gals(f"{stem}.fit", pos)
    with open(f"{stem}.txt", "w") as fp:
        fp.write(f"{stem}.fit\n")
    return f"{stem}.txt", pos


def gals_run(device, out, sht_order, ray_order, ngals, particles,
             profile=False, counted=False):
    """Raytracer.run with GalsFileList (ngals sources at 300-1900 Mpc/h,
    seed 31) and GalOutputName over 8 planes, f32, each plane's particles
    through load_particles: `particles(cfg, cosmo, p)`.  Returns the
    Raytracer, the launches of the run, those of each plane, the rays
    before plane GALS_SEARCH_PLANE's step (the step never writes into
    them), its seconds and the peak device memory."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    os.makedirs(out, exist_ok=True)
    glist, _ = write_catalog(f"{out}/sources", ngals, 31, 300.0, 1900.0)
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=sht_order, rayOrder=ray_order,
                         bundleOrder=3, Precision="f32", Profile=profile,
                         GalsFileList=glist, GalOutputName="gal_",
                         OutputPath=f"{out}/run").finalize()
    gc.collect()
    rt = Raytracer(cfg, device=device)
    rt.load_particles = lambda p: particles(cfg, rt.cosmo, p)
    plane_counts, snap = [], {}
    step = rt.step

    def counted_step(p, *a, **k):
        if p == GALS_SEARCH_PLANE:
            snap["rays"] = rt.rays_packed
        before = dict(_ext.launches)
        out_ = step(p, *a, **k)
        plane_counts.append({k_: v - before[k_]
                             for k_, v in _ext.launches.items()})
        return out_

    rt.step = counted_step
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    t0 = time.perf_counter()
    rt.run(progress=False)
    run_s = time.perf_counter() - t0
    launches = dict(_ext.launches)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    check(bool(torch.isfinite(rt.rays_packed).all()),
          f"run() with galaxies on {device}: non-finite rays")
    return rt, launches, plane_counts, snap["rays"], run_s, peak


def plane_images(rt, num_planes=8):
    """plane -> the image rows that run() wrote for it."""
    from calclens_tpu_torch.gals import io as galsio

    out = {}
    for p in range(num_planes):
        fn = os.path.join(rt.cfg.OutputPath, f"gal_{p:04d}.0000.fit")
        if os.path.exists(fn):
            out[p] = galsio.read_image_gals(fn)
    return out


def search_card_vs_cpu(cfg, rays, gal_pos, wpm1, wpm2):
    """find_images_device on the same float32 buffer on the card and on
    the CPU, and on the buffer in float64 on the card: the three index
    multisets equal; card vs CPU, positions within GALS_POS_BOUND of a ray
    pixel off the polar caps, and positions and A within GALS_F64_FACTOR
    times the card's float32 distance from float64.  Returns the
    distances: card vs CPU (positions off the caps, positions, A), float32
    vs float64 (positions, A), A off the caps card vs CPU and float32 vs
    float64, in ray pixels and of max |A|."""
    from calclens_tpu_torch.gals import gridsearch as gs
    from calclens_tpu_torch.healpix import core as hp
    from calclens_tpu_torch.healpix import torchhp

    tab = torchhp.InterpTables(cfg.rayOrder)
    idx = np.arange(len(gal_pos))
    runs = [gs.find_images_device(cfg, tab, r, gal_pos, idx, wpm1, wpm2)
            for r in (rays, rays.cpu(), rays.double())]
    orders = [np.lexsort((x.ra, x.index)) for x in runs]
    got, ref, exact = ([getattr(x, k)[o] for k in ("index", "ra", "dec", "A")]
                       for x, o in zip(runs, orders))
    check(np.array_equal(got[0], ref[0]) and np.array_equal(got[0], exact[0]),
          f"search card vs CPU vs float64: {len(got[0])}, {len(ref[0])} and "
          f"{len(exact[0])} images, or their source indices differ")
    pix = np.sqrt(4.0 * np.pi / hp.order2npix(cfg.rayOrder))
    amax = float(np.abs(exact[3]).max())
    cap = np.abs(exact[2]) > GALS_POLAR_DEC

    def dist(a, b):
        d = np.linalg.norm(hp.radec2vec(a[1], a[2])
                           - hp.radec2vec(b[1], b[2]), axis=1) / pix
        da = np.abs(a[3] - b[3]).reshape(len(d), -1).max(axis=1) / amax
        return d, float(da.max()), float(da[~cap].max())

    (d, a_err, a_off), (d64, a64, a64_off) = (dist(got, ref),
                                              dist(got, exact))
    off = float(d[~cap].max())
    check(off < GALS_POS_BOUND and d.max() <= GALS_F64_FACTOR * d64.max()
          and a_err <= GALS_F64_FACTOR * a64,
          f"search card vs CPU: positions {off:.3e} of a pixel off the caps "
          f"(bound {GALS_POS_BOUND:g}), {d.max():.3e} with them, A "
          f"{a_err:.3e} of max |A|; float32 vs float64 {d64.max():.3e} and "
          f"{a64:.3e} (factor {GALS_F64_FACTOR:g})")
    return off, float(d.max()), a_err, float(d64.max()), a64, a_off, a64_off


def search_alone(cfg, rt, rays, ngals):
    """The search alone on the headline rays before plane
    GALS_SEARCH_PLANE, ngals sources in its bin (tools/bench_gals.py's
    shape): the device search (its dispatch under
    torch.cuda.set_sync_debug_mode("error"): a host sync there raises),
    then find_images_born, each timed after one warm-up chunk.  Returns
    seconds, images and dispatch seconds."""
    import torch
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.gals import gridsearch as gs
    from calclens_tpu_torch.healpix import torchhp

    pp = plane_params(cfg, rt.cosmo, GALS_SEARCH_PLANE)
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    rng = np.random.default_rng(5)
    v = rng.normal(size=(ngals, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * rng.uniform(GALS_SEARCH_PLANE * binL + 1.0,
                          (GALS_SEARCH_PLANE + 1) * binL - 1.0, (ngals, 1))
    idx = np.arange(ngals)
    tab = torchhp.InterpTables(cfg.rayOrder)
    args = (pp.rad, pp.rad_minus1)
    gs.find_images_device(cfg, tab, rays, pos[:16384], idx[:16384], *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        collect = gs.find_images_device_async(cfg, tab, rays, pos, idx,
                                              *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dispatch_s = time.perf_counter() - t0
    dev = collect()
    dev_s = time.perf_counter() - t0
    gs.find_images_born(cfg, tab, rays, pos[:16384], idx[:16384], *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    born = gs.find_images_born(cfg, tab, rays, pos, idx, *args)
    born_s = time.perf_counter() - t0
    check(len(born.index) == ngals, "find_images_born lost sources")
    check(np.array_equal(np.unique(dev.index), idx),
          f"search alone: {ngals - len(np.unique(dev.index))} sources "
          f"without an image")
    return dict(dev_s=dev_s, dispatch_s=dispatch_s, born_s=born_s,
                images=len(dev.index), pos=pos)


def run_cmb(device, restart_dir, cfg_kw, out):
    """A new Raytracer loads the legacy restart in restart_dir and runs
    run_cmb_mode with CMBMapOrder CMB_MAP_ORDER into out: the three files,
    read back.  Returns (seconds, rays at the CMB on the host, the ray map
    table, the convergence, the legacy file's meta)."""
    import torch
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.io import fits
    from calclens_tpu_torch.io import legacy_restart as lr
    from calclens_tpu_torch.raytrace import run_cmb_mode

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         bundleOrder=3, Precision="f32", CMBLensing=1,
                         OutputPath=out, **cfg_kw).finalize()
    gc.collect()
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device=device)
    rt.load_legacy_restart(restart_dir)
    written = run_cmb_mode(rt)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nside = 1 << cfg.CMBMapOrder
    names = sorted(os.path.basename(w) for w in written)
    check(names == sorted(["restart_rays_at_cmb.0",
                           f"CMB_convergence_{nside}.fits",
                           f"CMB_rays_{nside}.fits"]),
          f"run_cmb_mode wrote {names}")
    meta, _, rays, _ = lr.read_legacy_restart_file(
        os.path.join(out, "restart_rays_at_cmb.0"))
    check(len(rays) == rt.rays_packed.shape[1],
          "restart_rays_at_cmb.0 does not read back")
    rec = fits.read_fits(os.path.join(out, f"CMB_rays_{nside}.fits"))[1][1]
    sig = fits.read_fits(os.path.join(
        out, f"CMB_convergence_{nside}.fits"))[1][1]["SIGNAL"]
    check(len(rec) == len(sig) == 12 * nside * nside
          and bool(np.isfinite(sig).all()), "CMB maps do not read back")
    return secs, rt.rays_packed.cpu(), rec, sig, meta


def gals_cmb_phase():
    """Phase 12: Raytracer.run with galaxies at the headline shape (the
    launches per plane, every source imaged, the GRIDSEARCH column, peak
    memory, the catalogs read back); the search alone on its rays; the
    search card vs CPU on one buffer; the CMB mode at full width from a
    legacy restart of the run's final rays; the same run and CMB mode at
    SHTOrder 7 / rayOrder 6, card vs CPU."""
    import tempfile

    import torch
    from calclens_tpu_torch import maps as tmaps
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.gals import concat
    from calclens_tpu_torch.io import legacy_restart as lr

    res = {}
    unit, mass = seeded_particles(GALS_HEAD_PARTICLES, 1.0, 12)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rt, launches, plane_counts, rays4, run_s, peak = gals_run(
            "cuda", f"{tmp}/head", *GALS_HEAD_ORDERS, GALS_HEADLINE,
            lambda cfg, cosmo, p: (unit * plane_params(cfg, cosmo, p).rad,
                                   mass),
            profile=True)
        check_plane_launches("headline run() with galaxies", plane_counts,
                             "NGP", GALS_HEAD_ORDERS[0])
        cfg = rt.cfg
        imgs = concat.read_all_images(cfg.OutputPath, "gal_", 8)
        per_source = np.bincount(imgs["index"], minlength=GALS_HEADLINE)
        missing = np.flatnonzero(per_source == 0)
        check(len(missing) == 0, f"headline run(): {len(missing)} sources "
              f"without an image, e.g. {missing[:10]}")
        rows = dict(rt.phase_rows)
        res["run"] = dict(
            seconds=run_s, peak=peak, launches=launches,
            steps=dict(rt.timings), images=len(imgs),
            multiple=int((per_source > 1).sum()),
            gridsearch={p: rows[p].get("GRIDSEARCH", 0.0) for p in rows},
            rows=rows, wall_s=time.perf_counter() - t0)

        res["alone"] = search_alone(cfg, rt, rays4, GALS_HEADLINE)
        pp = plane_params(cfg, rt.cosmo, GALS_SEARCH_PLANE)
        res["cpu"] = search_card_vs_cpu(
            cfg, rays4, res["alone"]["pos"][:GALS_CPU_CHECK], pp.rad,
            pp.rad_minus1)
        del rays4

        # the CMB mode at full width from the run's final rays
        t0 = time.perf_counter()
        lr.write_legacy_restart(tmp, cfg, rt.rays_packed.cpu().numpy(),
                                rt.ray_nest, rt.current_plane)
        write_s = time.perf_counter() - t0
        del rt
        torch.cuda.empty_cache()
        sht, ray = GALS_HEAD_ORDERS
        secs, crays, rec, sig, meta = run_cmb(
            "cuda", tmp, dict(SHTOrder=sht, rayOrder=ray,
                              CMBMapOrder=min(CMB_MAP_ORDER, ray)),
            f"{tmp}/cmb")
        w_cmb = float(tmaps.comoving_distance_2f1(1100.0, 0.3))
        rad_err = float(np.abs(np.linalg.norm(
            crays[0:3].double().numpy(), axis=0) / w_cmb - 1.0).max())
        check(int(rec["N_RAYS"].sum()) == 12 * 4**ray and
              rad_err < CMB_RADIUS_BOUND and meta["CurrentPlaneNum"] == 8,
              f"CMB at full width: {int(rec['N_RAYS'].sum())} rays, radii "
              f"{rad_err:.3e} off chi(1100)")
        res["cmb"] = dict(seconds=secs, write_s=write_s, rad_err=rad_err,
                          kappa_rms=float(np.sqrt(np.mean(sig ** 2))))
        del crays
        torch.cuda.empty_cache()

        # SHTOrder 7 / rayOrder 6: run() with galaxies and the CMB mode,
        # card vs CPU
        runs = {}
        for dev in ("cpu", "cuda"):
            rt, launches, plane_counts, _, run_s, _ = gals_run(
                dev, f"{tmp}/trace_{dev}", *GALS_TRACE_ORDERS, GALS_TRACE,
                lambda cfg, cosmo, p: pixel_centre_particles(
                    cfg, cosmo, p, 20000, 100 + p))
            runs[dev] = (rt, plane_images(rt))
        check_plane_launches("order-7/6 run() with galaxies", plane_counts,
                             "NGP", GALS_TRACE_ORDERS[0])
        diffs = {}
        for p, ref in runs["cpu"][1].items():
            got = runs["cuda"][1].get(p)
            check(got is not None, f"plane {p}: no catalog on the card")
            a, b = set(got["index"].tolist()), set(ref["index"].tolist())
            d = sorted(a ^ b)
            diffs[p] = (len(b), d)
            check(len(d) <= GALS_SET_SLACK * len(b),
                  f"order-7/6 run() plane {p}: {len(d)} of {len(b)} "
                  f"sources imaged on one device only: {d}")
        res["trace_sets"] = diffs
        rt_cpu = runs["cpu"][0]
        lr.write_legacy_restart(f"{tmp}/trace_cpu", rt_cpu.cfg,
                                rt_cpu.rays_packed.numpy(), rt_cpu.ray_nest,
                                rt_cpu.current_plane)
        del runs
        sht, ray = GALS_TRACE_ORDERS
        cmb = {dev: run_cmb(dev, f"{tmp}/trace_cpu",
                            dict(SHTOrder=sht, rayOrder=ray,
                                 CMBMapOrder=ray - 2),
                            f"{tmp}/cmb7_{dev}") for dev in ("cpu", "cuda")}
        (_, rg, mg, sg, _), (_, rc, mc, sc, _) = cmb["cuda"], cmb["cpu"]
        err = grouped_row_err(rg, rc)
        check(np.array_equal(mg["N_RAYS"], mc["N_RAYS"]),
              "CMB order 7/6: ray counts differ between card and CPU")
        amax = max(float(np.abs(mc[k]).max())
                   for k in ("A00", "A01", "A10", "A11"))
        for k, scale in (("A00", amax), ("A01", amax), ("A10", amax),
                         ("A11", amax), ("ra", float(np.abs(mc["ra"]).max())),
                         ("dec", float(np.abs(mc["dec"]).max()))):
            err = max(err, float(np.abs(mg[k] - mc[k]).max()) / scale)
        err = max(err, float(np.abs(sg - sc).max()) / amax)
        check(err < TRACE_BOUND, f"CMB order 7/6 card vs CPU: {err:.3e}")
        res["cmb_trace_err"] = err
    return res


def report_gals_cmb(res, card):
    r = res["run"]
    sht, ray = GALS_HEAD_ORDERS
    say(f"phase 12 ({card}): headline run() with galaxies, SHTOrder {sht} / "
        f"rayOrder {ray} / {GALS_HEAD_PARTICLES} particles per plane f32, 8 "
        f"planes, Profile on, {GALS_HEADLINE} sources at 300-1900 Mpc/h: "
        f"run {r['seconds']:.2f} s ({r['wall_s']:.2f} s with the catalog "
        f"written and read back), {r['images']} images, {r['multiple']} sources with more than "
        f"one image, every source imaged; K1 once and K2 once per j-block "
        f"per plane "
        f"({r['launches']['legendre_analysis']} and "
        f"{r['launches']['legendre_synth']} in the run); peak "
        f"{r['peak'] / 2**30:.2f} GiB")
    for p, row in sorted(r["rows"].items()):
        step = r["steps"][p]
        say(f"  plane {p}: step {step:.4f} s, GRIDSEARCH "
            f"{row.get('GRIDSEARCH', 0.0):.4f} s, "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(row.items())
                        if k != "GRIDSEARCH"))
    a = res["alone"]
    say(f"phase 12 ({card}): the search alone on the headline rays before "
        f"plane {GALS_SEARCH_PLANE}, {GALS_HEADLINE} sources in its bin: "
        f"find_images_device {a['dev_s']:.3f} s = "
        f"{GALS_HEADLINE / a['dev_s']:.0f} gals/s ({a['images']} images; "
        f"its dispatch {a['dispatch_s']:.3f} s with no host sync), "
        f"find_images_born {a['born_s']:.3f} s = "
        f"{GALS_HEADLINE / a['born_s']:.0f} gals/s")
    off, pos, a_err, pos64, a64, a_off, a64_off = res["cpu"]
    say(f"phase 12: the search on one float32 buffer, card vs CPU, "
        f"{GALS_CPU_CHECK} sources: index multisets equal (and equal to a "
        f"float64 search's); positions {off:.3e} of a ray pixel for |dec| "
        f"<= {GALS_POLAR_DEC:g} (bound {GALS_POS_BOUND:g}), {pos:.3e} "
        f"with the caps, A {a_off:.3e} of max |A| for |dec| <= "
        f"{GALS_POLAR_DEC:g}, {a_err:.3e} with the caps; the card's float32 "
        f"vs float64: positions {pos64:.3e}, A {a64_off:.3e} and {a64:.3e} "
        f"(bound {GALS_F64_FACTOR:g}x the whole-sky ones)")
    c = res["cmb"]
    say(f"phase 12 ({card}): CMB mode at full width from a legacy restart "
        f"of the run's rays (written in {c['write_s']:.2f} s): "
        f"load_legacy_restart + run_cmb_mode at CMBMapOrder "
        f"{min(CMB_MAP_ORDER, ray)} {c['seconds']:.2f} s, {12 * 4**ray} "
        f"rays at "
        f"chi(1100) within {c['rad_err']:.3e} (bound "
        f"{CMB_RADIUS_BOUND:g}), rms kappa {c['kappa_rms']:.4e}; three "
        f"files read back")
    sht, ray = GALS_TRACE_ORDERS
    say(f"phase 12: order-{sht}/{ray} run() with galaxies ({GALS_TRACE} "
        f"sources), card vs CPU, per plane "
        "(sources imaged, on one device only): "
        + "; ".join(f"{p}: {n}, {d}" for p, (n, d)
                    in sorted(res["trace_sets"].items()))
        + f"; CMB mode card vs CPU {res['cmb_trace_err']:.3e} (bound "
        f"{TRACE_BOUND:g})")


def event_phase(parts):
    """A plane step's phase hook that times each part with CUDA events:
    parts[tag] collects (start, stop) pairs."""
    import torch

    def phase(tag, fn, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        parts.setdefault(tag, []).append((a, b))
        return out

    return phase


def mg_config(orders, **kw):
    from calclens_tpu_torch.config import RayTraceConfig

    sht, ray, bundle = orders
    return RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0,
                          NumLensPlanes=8, SHTOrder=sht, rayOrder=ray,
                          bundleOrder=bundle, Precision="f32", SHTOnly=False,
                          **kw).finalize()


def mg_design_point(ref_dir=None):
    """The multigrid step at its design point (MG_ORDERS, MG_PARTICLES
    seeded particles, f32, NGP map deposit and the CIC patch deposit, 10
    fixed V-cycles) through Raytracer.step: MG_DESIGN_PLANES (the first
    a warm-up, the last timed with Profile set: the driver's host-timed
    phase row), plane 5 with its parts timed by CUDA events and plane 5
    again from the same rays (equal bit for bit), the patch deposit of its
    particles twice (equal bit for bit, CUDA-event ms); K1
    and K2-4col launched exactly once per plane and nothing else, the peak
    device memory under DEVICE_MEMORY, finite rays.  With ref_dir, the
    rays after MG_DESIGN_PLANES are written there as phase 17's one-rank
    reference (p17_save_mg_ref).  Then a new Raytracer with MGConvFact 0.1
    and DepositScheme SPH steps plane 2 once: its time and V-cycles; then
    its spline patch deposit of that plane's particles twice, equal bit for
    bit."""
    import torch
    from calclens_tpu_torch import _ext, mgdriver
    from calclens_tpu_torch.driver import Raytracer, plane_params
    from calclens_tpu_torch.ops.deposit import smoothing_lengths
    from calclens_tpu_torch.poisson import plane_scalars

    gc.collect()
    torch.cuda.empty_cache()
    cfg = mg_config(MG_ORDERS)
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device="cuda")
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nrays = rt.rays_packed.shape[1]
    pos, mass = seeded_particles(MG_PARTICLES, 1.0, 12)
    staged = {p: rt.stage_particles(pos * (250.0 * p + 125.0), mass)
              for p in (*MG_DESIGN_PLANES, 5)}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    plane_counts, times = [], []
    for p in MG_DESIGN_PLANES:
        rt.cfg.Profile = p == MG_DESIGN_PLANES[-1]
        before = dict(_ext.launches)
        t = time.perf_counter()
        rt.step(p, *staged[p])  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        plane_counts.append({k: v - before[k]
                             for k, v in _ext.launches.items()})
    launches = dict(_ext.launches)
    peak = torch.cuda.max_memory_allocated()
    if ref_dir is not None:
        p17_save_mg_ref(rt.rays_packed, ref_dir)
    check_plane_launches("MG design point", plane_counts, "MG")
    check(peak < DEVICE_MEMORY, f"MG design point peak {peak / 1e9:.2f} GB")
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "MG design point: non-finite rays")
    p = MG_DESIGN_PLANES[-1]
    profile = (rt.timings[-1][1], dict(dict(rt.phase_rows)[p]))
    # plane 5 from a copy of the rays, its parts timed; then plane 5 again
    # from the same rays: the two equal bit for bit
    state = rt.rays_packed
    rt.rays_packed = state.clone()
    parts = {}
    rt._timed_phase = lambda plane_num: event_phase(parts)
    rt.cfg.Profile = True  # the step passes the hook only in Profile mode
    t = time.perf_counter()
    rt.step(5, *staged[5])  # ends in torch.cuda.synchronize()
    parts_step_s = time.perf_counter() - t
    rt.cfg.Profile = False
    del rt._timed_phase
    part_ms = {tag: sum(a.elapsed_time(b) for a, b in parts[tag])
               for tag in MG_PARTS}
    first, rt.rays_packed = rt.rays_packed, state
    del state
    t = time.perf_counter()
    rt.step(5, *staged[5])
    again_s = time.perf_counter() - t
    check(torch.equal(first, rt.rays_packed),
          "MG design point: plane 5 twice from the same rays differs")
    del first
    torch.cuda.empty_cache()
    # the patch deposit twice on plane 5's particles
    scal = plane_scalars(plane_params(cfg, rt.cosmo, 5), rt.dtype, rt.device)
    pos_d, mass_d = rt._pad_particles(*staged[5])
    grids, deposit_ms = [], []
    for _ in range(2):
        g, ms = timed_once(lambda: mgdriver.deposit_patches(
            rt.mgsetup, pos_d, mass_d, scal.densfact, scal.backdens))
        grids.append(g)
        deposit_ms.append(ms)
    check(torch.equal(*grids), "MG design point: two patch deposits of one "
          "plane differ")
    del grids, pos_d, mass_d
    torch.cuda.empty_cache()
    cycles = dict(rt.mg_cycles)
    check(set(cycles.values()) == {10}, f"MG fixed solve cycles {cycles}")
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "MG design point: non-finite rays after the Profile'd planes")
    patch = (rt.mgsetup.C, rt.mgsetup.levels[0].N)
    del rt, staged
    gc.collect()
    torch.cuda.empty_cache()

    # MGConvFact 0.1 and the spline patch deposit
    cfg_s = mg_config(MG_ORDERS, MGConvFact=0.1, DepositScheme="SPH")
    rs = Raytracer(cfg_s, device="cuda")
    rs.init_rays()
    pos_d, mass_d = rs.stage_particles(pos * 625.0, mass)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_ext.launches)
    t = time.perf_counter()
    rs.step(2, pos_d, mass_d)
    sph_s = time.perf_counter() - t
    check_plane_launches("MG SPH plane", [
        {k: v - before[k] for k, v in _ext.launches.items()}], "MG")
    sph_peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(rs.rays_packed).all()),
          "MG SPH plane: non-finite rays")
    sph_cycles = rs.mg_cycles[2]
    # the spline patch deposit (each bucket's CIC patch grid convolved by
    # cuDNN or by FFTs) twice on the plane's particles
    pos_p, mass_p = rs._pad_particles(pos_d, mass_d)
    sl = smoothing_lengths(pos_p, *rs.sph[-3:])
    grids = [mgdriver.deposit_patches_sph(rs.mgsetup, pos_p, mass_p, sl, 1.0,
                                          0.0, rs.mgsetup.sph_sigmas)
             for _ in range(2)]
    check(torch.equal(*grids), "MG SPH: two spline patch deposits of one "
          "plane differ")
    del rs, pos_d, mass_d, pos_p, mass_p, sl, grids
    gc.collect()
    torch.cuda.empty_cache()
    return dict(setup_s=setup_s, times=times, nrays=nrays,
                resident=resident, peak=peak, launches=launches,
                plane_counts=plane_counts, profile=profile,
                part_ms=part_ms, parts_step_s=parts_step_s, patch=patch,
                sph_s=sph_s, sph_peak=sph_peak, sph_cycles=sph_cycles,
                again_s=again_s, deposit_ms=deposit_ms)


def mg_trace(**cfg_kw):
    """A CUDA-vs-CPU MG trace of MG_TRACE_PLANES at MG_TRACE_ORDERS, f32, particles at
    pixel centres (cfg_kw on the configuration): the packed rays within
    TRACE_BOUND of each quantity's max after every plane, the card's
    launches PLANE_LAUNCHES["MG"] per plane.  Returns (errors per plane,
    V-cycles per plane on the CPU and on the card)."""
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.driver import Raytracer

    cfg = mg_config(MG_TRACE_ORDERS, **cfg_kw)
    cpu = Raytracer(cfg, device="cpu")
    gpu = Raytracer(cfg, device="cuda")
    for rt in (cpu, gpu):
        rt.init_rays()
    errs, plane_counts = [], []
    for p in range(MG_TRACE_PLANES):
        pos, mass = pixel_centre_particles(cfg, cpu.cosmo, p, 20000, 100 + p)
        cpu.step(p, pos=pos, mass=mass)
        before = dict(_ext.launches)
        gpu.step(p, pos=pos, mass=mass)
        plane_counts.append({k: v - before[k]
                             for k, v in _ext.launches.items()})
        errs.append(grouped_row_err(gpu.rays_packed.cpu(), cpu.rays_packed))
    check_plane_launches(f"MG trace {cfg_kw}", plane_counts, "MG")
    cycles = (dict(cpu.mg_cycles), dict(gpu.mg_cycles))
    check(max(errs) < TRACE_BOUND, f"MG trace {cfg_kw}, CUDA vs CPU: {errs} "
          f"(V-cycles CPU, card: {cycles})")
    return errs, cycles


def ray_file_columns(paths, fmt):
    """The rows of a write's files, concatenated, and their layouts."""
    from calclens_tpu_torch.io import rayio

    read = rayio.read_rays_bin if fmt == "bin" else rayio.read_rays
    parts = [read(p) for p in paths]
    return (np.concatenate([r for _, _, _, r in parts]),
            [(h, c, s) for h, c, s, _ in parts])


def ray_outputs(snap):
    """The headline rays `snap` (rayOrder 10, after plane 3) written by the
    driver's writer (Raytracer.write_rays) from the card in RAY_FILES files,
    as FITS and as binary: seconds and bytes of each; both read back
    (layouts and rows equal between the formats) and held to a float64
    transform of the same buffer (on the card), each float column within
    RAY_F64_FACTOR times the float32 CPU transform's own distance from it
    (NEST, counts and starts equal)."""
    import tempfile

    import torch
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    out = {}
    ray_order = int(round(math.log(snap.shape[1] / 12, 4)))
    with tempfile.TemporaryDirectory() as tmp:
        def writer(device, dtype, fmt):
            cfg = RayTraceConfig(
                OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                SHTOrder=4, rayOrder=ray_order, bundleOrder=3,
                Precision="f32",
                OutputPath=f"{tmp}/{device}-{dtype}-{fmt}",
                RayOutputName="ray_", NumRayOutputFiles=RAY_FILES,
                OutputRayDeflections=True, OutputPhi=True,
                RayOutputFormat=fmt).finalize()
            rt = Raytracer(cfg, device=device, dtype=dtype)
            rt.load_state(snap, 4)
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            paths = rt.write_rays()
            s_ = time.perf_counter() - t
            nbytes = sum(os.path.getsize(p) for p in paths)
            del rt
            return paths, s_, nbytes

        card = {}
        for fmt in ("fits", "bin"):
            paths, s_, nbytes = writer("cuda", torch.float32, fmt)
            card[fmt] = ray_file_columns(paths, fmt)
            out[fmt] = (s_, nbytes, len(paths))
        torch.cuda.empty_cache()
        (rows, lay), (rows_b, lay_b) = card["fits"], card["bin"]
        check(len(rows) == snap.shape[1], f"ray files hold {len(rows)} rows")
        check(all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                  for a, b in zip(lay, lay_b)), "FITS and binary layouts "
              "differ")
        check(all(np.array_equal(rows[f], rows_b[f])
                  for f in rows.dtype.names), "FITS and binary rows differ")
        ref = {}
        for device, dt in (("cuda", torch.float64), ("cpu", torch.float32)):
            paths, s_, _ = writer(device, dt, "fits")
            ref[dt] = ray_file_columns(paths, "fits")
            out[f"{device}_{str(dt)[6:]}_s"] = s_
        torch.cuda.empty_cache()
        (r64, lay64), (r32, _) = ref[torch.float64], ref[torch.float32]
        check(all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                  for a, b in zip(lay, lay64)), "ray file layouts differ "
              "from the float64 write's")
        check(np.array_equal(rows["nest"], r64["nest"]),
              "NEST column differs from the float64 write's")
        dist = {}
        for f in rows.dtype.names[1:]:
            d_card = float(np.abs(rows[f] - r64[f]).max())
            d_cpu = float(np.abs(r32[f] - r64[f]).max())
            dist[f] = (d_card, d_cpu)
            check(d_card <= RAY_F64_FACTOR * d_cpu,
                  f"ray column {f}: card {d_card:.3e} from float64, float32 "
                  f"on the CPU {d_cpu:.3e}")
        out["dist"] = dist
    return out


def traced_run_outputs():
    """Raytracer.run at the trace's shape (SHTOrder 7 / rayOrder 6, 8
    planes) with lens maps after planes 1 and 2, MaxResMap, RayOutputName
    (2 files), OutputRayDeflections, OutputPhi and DebugIO, in float32 on
    the card and on the CPU and in float64 on the CPU: ray files at both
    map planes and at the end, six field maps per plane.  The card's files
    against the CPU's: names equal; NEST, counts and starts equal; each
    quantity (the ray files' as the trace groups them, A's four columns
    and alpha's two together) and each map within the larger of
    TRACE_BOUND and RAY_F64_FACTOR times the float32 CPU file's own
    distance from the float64 one (the files after 8 planes carry 8
    planes of float32 rounding, the trace's bound 3).  Returns ({file set:
    (card vs CPU, float32 vs float64, worst quantity)}, files compared)."""
    import tempfile

    import torch
    from calclens_tpu_torch.io import fits, rayio

    extra = dict(MaxResMap=1, RayOutputName="ray_", NumRayOutputFiles=2,
                 OutputRayDeflections=True, OutputPhi=True, DebugIO=True)
    runs = (("cuda", None), ("cpu", None), ("cpu", torch.float64))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [traced_run(dev, tmp, (1, 2), dtype=dt, **extra)[0]
                .cfg.OutputPath for dev, dt in runs]
        names = [sorted(n for n in os.listdir(d)
                        if n.startswith(("ray_", "debug_"))) for d in dirs]
        check(names[0] == names[1] == names[2],
              f"run() outputs differ: {names}")
        rays = [n for n in names[0] if n.startswith("ray_")]
        dbg = [n for n in names[0] if n.startswith("debug_")]
        check(len(rays) == 6 and len(dbg) == 6 * 8,
              f"run() wrote {len(rays)} ray files, {len(dbg)} field maps")
        errs = {}

        def dist(got, ref):
            return (float(np.abs(got.astype(np.float64) - ref).max())
                    / max(float(np.abs(ref).max()), 1e-30))

        def note(key, what, g, c, r):
            """errs[key]: (card vs CPU, CPU float32 vs float64, what) of the
            quantity with the least room under its bound so far."""
            e = (dist(g, c), dist(c, r), what)
            old = errs.get(key)
            room = e[0] / max(TRACE_BOUND, RAY_F64_FACTOR * e[1])
            if old is None or room > old[0] / max(TRACE_BOUND,
                                                  RAY_F64_FACTOR * old[1]):
                errs[key] = e

        for n in rays:
            files = [rayio.read_rays(os.path.join(d, n)) for d in dirs]
            (hg, cg, sg, rg), (hc, cc, sc, rc), (_, _, _, r64) = files
            check(hc == hg and np.array_equal(cc, cg)
                  and np.array_equal(sc, sg)
                  and np.array_equal(rc["nest"], rg["nest"])
                  and np.array_equal(r64["nest"], rg["nest"]),
                  f"{n}: header, layout or NEST differ")
            for q, cols in (("ra", ["ra"]), ("dec", ["dec"]),
                            ("A", ["A00", "A01", "A10", "A11"]),
                            ("alpha", ["alpha0", "alpha1"]),
                            ("phi", ["phi"])):
                note(n[:8], q, *(np.stack([x[c] for c in cols])
                                 for x in (rg, rc, r64)))
        for n in dbg:
            g, c, r = (fits.read_fits(os.path.join(d, n))[1][1]["SIGNAL"]
                       for d in dirs)
            note(f"debug plane {n[-9:-5]}", n[6:-10], g, c, r)
    say("phase 13: run() outputs, card vs CPU (float32 CPU vs float64 CPU), "
        "the quantity nearest its bound in each file set, of its max: "
        + ", ".join(f"{k} {a:.2e} ({b:.2e}, {w})"
                    for k, (a, b, w) in sorted(errs.items())))
    bad = {k: v for k, v in errs.items()
           if v[0] >= max(TRACE_BOUND, RAY_F64_FACTOR * v[1])}
    check(not bad, f"run() outputs, card vs CPU: {bad}")
    return errs, len(rays) + len(dbg)


def mg_rayio_phase(snap, card, ref_dir=None):
    """Phase 13: the MG design point (its rays kept in ref_dir for phase
    17), the small MG traces and the ray outputs, each part's lines printed
    as it ends."""
    res = {"design": mg_design_point(ref_dir)}
    report_mg_design(res["design"], card)
    for label, kw in (("default", {}), ("MGConvFact 0.1 + SPH",
                                        dict(MGConvFact=0.1,
                                             DepositScheme="SPH"))):
        errs, cycles = res[label] = mg_trace(**kw)
        say(f"phase 13: MG trace order {MG_TRACE_ORDERS} f32 {label}, CUDA "
            f"vs CPU per plane: {', '.join(f'{e:.3e}' for e in errs)} (bound "
            f"{TRACE_BOUND:g}); V-cycles CPU {cycles[0]}, card {cycles[1]}")
    res["rays"] = ray_outputs(snap)
    report_ray_outputs(res["rays"], card)
    errs, nfiles = res["run"] = traced_run_outputs()
    say(f"phase 13: run() order 7/6 with MaxResMap, RayOutputName, "
        f"OutputRayDeflections, OutputPhi and DebugIO: {nfiles} files, card "
        f"vs CPU at most {max(e[0] for e in errs.values()):.3e} of a "
        f"quantity's max (bound: the larger of {TRACE_BOUND:g} and "
        f"{RAY_F64_FACTOR:g}x the float32 CPU file's distance from float64)")
    return res


def report_mg_design(d, card):
    per_plane = float(np.median(d["times"][1:]))
    sht, ray, bundle = MG_ORDERS
    say(f"phase 13 ({card}): MG design point SHTOrder {sht} / rayOrder {ray} "
        f"/ bundleOrder {bundle} ({d['patch'][0]} patches of "
        f"{d['patch'][1]}^2) / 2^21 particles f32, 10 V-cycles: planes "
        f"(warm-up, timed) {', '.join(f'{t:.4f}' for t in d['times'])} s, "
        f"{per_plane:.4f} s/plane, {d['nrays'] / per_plane:.0f} rays/s, "
        f"peak {d['peak'] / 2**30:.2f} GiB ({d['resident'] / 2**30:.2f} GiB "
        f"resident), setup {d['setup_s']:.2f} s, launches per plane "
        + "; ".join(str({k: v for k, v in c.items() if v})
                    for c in d["plane_counts"]))
    step, row = d["profile"]
    say(f"phase 13: MG Profile'd plane: step {step:.4f} s; "
        + ", ".join(f"{k} {v:.4f} s" for k, v in row.items()))
    say(f"phase 13: MG step's parts by CUDA events (plane of "
        f"{d['parts_step_s']:.4f} s): "
        + ", ".join(f"{k} {d['part_ms'][k]:.2f} ms" for k in MG_PARTS)
        + f"; SHT solve (DEPOSIT + SHTSOLVE + SHT) "
        f"{sum(d['part_ms'][k] for k in MG_PARTS[:3]):.2f} ms")
    say(f"phase 13: MG plane 5 again from the same rays ({d['again_s']:.4f} "
        f"s): rays equal bit for bit; the patch deposit twice ("
        + ", ".join(f"{t:.2f}" for t in d["deposit_ms"])
        + " ms): equal bit for bit")
    say(f"phase 13: MG with MGConvFact 0.1 and SPH, one plane: "
        f"{d['sph_s']:.4f} s, {d['sph_cycles']} V-cycles, peak "
        f"{d['sph_peak'] / 2**30:.2f} GiB; its spline patch deposit twice: "
        f"equal bit for bit")


def report_ray_outputs(r, card):
    for fmt in ("fits", "bin"):
        s_, nbytes, nf = r[fmt]
        say(f"phase 13 ({card}): headline rays written as {fmt} ({nf} "
            f"files, {nbytes} bytes) in {s_:.3f} s, {nbytes / s_ / 1e9:.3f} "
            f"GB/s")
    say(f"phase 13: the same rays written in float64 on the card "
        f"{r['cuda_float64_s']:.3f} s, in float32 on the CPU "
        f"{r['cpu_float32_s']:.3f} s; "
        f"card vs float64 (float32 CPU vs float64) per column: "
        + ", ".join(f"{k} {a:.3e} ({b:.3e})" for k, (a, b) in
                    r["dist"].items())
        + f" (bound {RAY_F64_FACTOR:g}x)")


def clumpy_snapshot(n, box, seed, clumps=TDP_CLUMPS):
    """n float32 positions in [0, box)^3 from a numpy seed: a uniform
    background, and TDP_CLUMP_SHARE of them in `clumps` Gaussian clumps of
    TDP_CLUMP_SIGMA."""
    rng = np.random.default_rng(seed)
    box = np.float32(box)
    nc = int(n * TDP_CLUMP_SHARE)
    pos = np.empty((n, 3), np.float32)
    pos[nc:] = rng.random((n - nc, 3), dtype=np.float32) * box
    centres = rng.random((clumps, 3), dtype=np.float32) * box
    pos[:nc] = centres[rng.integers(0, clumps, nc)]
    pos[:nc] += rng.standard_normal((nc, 3), dtype=np.float32) * np.float32(
        TDP_CLUMP_SIGMA)
    np.mod(pos[:nc], box, out=pos[:nc])
    return pos


def write_lgadget(stem, pos, box, time_a, nfiles):
    """pos as one LGadget snapshot of nfiles files (<stem>.0 ... when
    nfiles > 1, else <stem>), each particle of the box's mean mass at
    OmegaM 0.3, through the port's io/lgadget.write_snapshot."""
    from calclens_tpu_torch.cosmology import RHO_CRIT
    from calclens_tpu_torch.io import lgadget

    n = len(pos)
    mass = RHO_CRIT * 0.3 * box ** 3 / n / 1e10
    for i, part in enumerate(np.array_split(pos, nfiles)):
        lgadget.write_snapshot(stem if nfiles == 1 else f"{stem}.{i}", part,
                               mass1_1e10=mass, time=time_a, boxsize=box,
                               num_files=nfiles, npart_total=n)


def threedpot_config(snaplist, ray_order, nfft, max_dist, planes):
    """A float32 full-sky THREEDPOT run (the SHT plan the Raytracer builds
    is not used; SHTOrder 6 keeps it small)."""
    from calclens_tpu_torch.config import RayTraceConfig

    return RayTraceConfig(OmegaM=0.3, maxComvDistance=max_dist,
                          NumLensPlanes=planes, SHTOrder=6,
                          rayOrder=ray_order, bundleOrder=min(ray_order, 5),
                          ThreeDPot=True, ThreeDPotSnapList=snaplist,
                          NFFT=nfft, Precision="f32").finalize()


def max_rel(got, ref, chunk=1 << 26):
    """max |got - ref| / max |ref| over flat views, in float64, chunk by
    chunk (no full float64 copy of a float32 grid)."""
    g, r = got.reshape(-1), ref.reshape(-1)
    num = den = 0.0
    for a in range(0, g.numel(), chunk):
        rr = r[a:a + chunk].double()
        num = max(num, float((g[a:a + chunk].double() - rr).abs().max()))
        den = max(den, float(rr.abs().max()))
    return num / den


def field_distances(padded, nfft, box, rows, plane_rad, binL, nint):
    """The THREEDPOT rows (alpha, U, phi) of the [21, R] rays `rows` from
    one padded grid, float32 against float64: (distances per quantity, the
    float32 rows)."""
    import torch
    from calclens_tpu_torch import fftpot

    out = {}
    for dtype in (torch.float32, torch.float64):
        r = rows.to(dtype).clone()
        r[14:21] = 0.0

        def s(x):
            return torch.tensor(x, dtype=dtype, device=rows.device)

        out[dtype] = fftpot.threedpot_rows(r, padded, nfft, nint, s(box),
                                           s(plane_rad), s(binL))
    f32, f64 = out[torch.float32], out[torch.float64]
    dist = {q: max_rel(f32[a:b], f64[a:b])
            for q, (a, b) in (("alpha", (14, 16)), ("U", (16, 20)),
                              ("phi", (20, 21)))}
    return dist, f32


def threedpot_full(tmp, keep_refs=False):
    """Phase 14's full-width run: the snapshot (TDP_PARTICLES in two
    files), Raytracer.step over TDP_PLANES planes, plane 0 (with the grid
    build) timed by parts with CUDA events; the fields of TDP_CHECK_RAYS
    rays against float64 on the card and on the CPU; the grid built again
    with cuFFT's plan cache as it is and cleared; the deposit's total and
    the float32 potential against float64 of the same counts (and the same
    comparison on the CPU at TDP_CPU_NFFT).  keep_refs: the snapshot stays
    in tmp, with the grid and the rays after P17_TDP_PLANES planes
    (p17_save_tdp_ref), phase 17's one-rank reference."""
    import torch
    from calclens_tpu_torch import fftpot
    from calclens_tpu_torch.cosmology import RHO_CRIT
    from calclens_tpu_torch.driver import Raytracer, plane_params
    from calclens_tpu_torch.io import lgadget

    res = {}
    t0 = time.perf_counter()
    pos = clumpy_snapshot(TDP_PARTICLES, TDP_BOX, 14)
    stem = os.path.join(tmp, "snap_full")
    write_lgadget(stem, pos, TDP_BOX, 1.0, 2)
    del pos
    res["snapshot_s"] = time.perf_counter() - t0
    res["snapshot_bytes"] = sum(os.path.getsize(f)
                                for f in fftpot.snapshot_files(stem))
    lst = os.path.join(tmp, "full.txt")
    with open(lst, "w") as fp:
        fp.write(stem + "\n")
    cfg = threedpot_config(lst, TDP_RAY_ORDER, TDP_NFFT, TDP_MAX_DIST,
                           TDP_PLANES)
    rt = Raytracer(cfg, device="cuda")
    rt.init_rays()
    nrays = rt.rays_packed.shape[1]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    rt._timed_phase = lambda plane_num: event_phase(parts)
    rt.cfg.Profile = True  # the step passes the hook only in Profile mode
    times = []
    for p in range(TDP_PLANES):
        if p == 1:
            rt.cfg.Profile = False
            del rt._timed_phase
        t = time.perf_counter()
        rt.step(p)  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if keep_refs and p == P17_TDP_PLANES - 1:
            p17_save_tdp_ref(rt, tmp)
    res["peak"] = torch.cuda.max_memory_allocated()
    res["part_ms"] = {tag: sum(a.elapsed_time(b) for a, b in parts[tag])
                      for tag in TDP_PARTS}
    check(rt.threedpot.builds == 1,
          f"THREEDPOT grid built {rt.threedpot.builds} times")
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "THREEDPOT: non-finite rays")
    check(res["peak"] < DEVICE_MEMORY,
          f"THREEDPOT peak {res['peak'] / 1e9:.2f} GB")
    res.update(times=times, nrays=nrays, radii=[
        plane_params(cfg, rt.cosmo, p).rad for p in range(TDP_PLANES)])

    # the fields of TDP_CHECK_RAYS rays at plane TDP_CHECK_PLANE, float32
    # against float64, on the card and (same grid, same rays) on the CPU
    grid, box, padded = rt.threedpot._cached[2:]
    binL = TDP_MAX_DIST / TDP_PLANES
    nint = rt.threedpot.nint(box, TDP_NFFT, binL)
    rad = plane_params(cfg, rt.cosmo, TDP_CHECK_PLANE).rad
    sel = torch.arange(0, nrays, nrays // TDP_CHECK_RAYS,
                       device="cuda")[:TDP_CHECK_RAYS]
    rows = rt.rays_packed[:, sel]
    card_d, card32 = field_distances(padded, TDP_NFFT, box, rows, rad, binL,
                                     nint)
    t = time.perf_counter()
    cpu_d, cpu32 = field_distances(padded.cpu(), TDP_NFFT, box, rows.cpu(),
                                   rad, binL, nint)
    res["fields_cpu_s"] = time.perf_counter() - t
    check(bool(torch.isfinite(card32).all()), "THREEDPOT fields non-finite")
    res["fields"] = dict(card=card_d, cpu=cpu_d, nint=nint, rad=rad,
                         card_vs_cpu=grouped_row_err(card32.cpu(), cpu32))
    for q in card_d:
        check(card_d[q] <= TDP_F64_FACTOR * cpu_d[q],
              f"THREEDPOT float32 {q} {card_d[q]:.3e} from float64 on the "
              f"card, {cpu_d[q]:.3e} on the CPU")
    # the built grid (its periodic padding, which the rays sample) in
    # pinned host memory, to hold the rebuilds below to it bit for bit
    padded_host = torch.empty(padded.shape, dtype=padded.dtype,
                              pin_memory=True)
    padded_host.copy_(padded)
    del grid, padded, rows, card32, cpu32
    # the last plane twice from the same rays on the same grid
    res["repeat"] = repeat_plane(rt, TDP_PLANES - 1)
    check(res["repeat"]["equal"], f"THREEDPOT: plane {TDP_PLANES - 1} twice "
          f"from the same rays differs")

    # the grid build again, cuFFT's plan cache as it is, then cleared
    builds = []
    for clear in (False, True):
        rt.threedpot._cached = None
        gc.collect()
        torch.cuda.empty_cache()
        if clear:
            torch.backends.cuda.cufft_plan_cache.clear()
        plans = torch.backends.cuda.cufft_plan_cache.size
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rt.threedpot.grid_for_plane(res["radii"][0], fftpot.MIN_SL)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        # the CUDA context and cuFFT's plans: device memory in use that
        # PyTorch's allocator does not hold
        builds.append(dict(cleared=clear, plans_before=plans, s=build_s,
                           peak=peak, plans_after=(
                               torch.backends.cuda.cufft_plan_cache.size),
                           outside=total - free
                           - torch.cuda.memory_reserved(),
                           equal=bool(torch.equal(
                               rt.threedpot._cached[4],
                               padded_host.to("cuda", non_blocking=True)))))
        check(builds[-1]["equal"], f"THREEDPOT: the grid built again "
              f"(plan cache cleared {clear}) differs from the first build")
    res["builds"] = builds
    del rt, padded_host
    gc.collect()
    torch.cuda.empty_cache()

    # the deposit's total, and the float32 potential against float64 of the
    # same counts: on the card at TDP_NFFT and TDP_CPU_NFFT, on the CPU at
    # TDP_CPU_NFFT
    # the grid deposit at TDP_NFFT twice (equal bit for bit, CUDA-event ms
    # summed over the files)
    counts = torch.zeros((TDP_NFFT,) * 3, dtype=torch.float32, device="cuda")
    again = torch.zeros_like(counts)
    coarse = torch.zeros((TDP_CPU_NFFT,) * 3, dtype=torch.float32,
                         device="cuda")
    deposit_ms = [0.0, 0.0]
    for fn in fftpot.snapshot_files(stem):
        pos, _ = lgadget.read_positions_f32(fn)
        pos_d = torch.from_numpy(pos).cuda()
        del pos
        for i, grid in enumerate((counts, again)):
            deposit_ms[i] += timed_once(lambda: fftpot.cic_deposit_3d(
                pos_d, TDP_NFFT, np.float32(TDP_BOX), grid))[1]
        fftpot.cic_deposit_3d(pos_d, TDP_CPU_NFFT, np.float32(TDP_BOX),
                              coarse)
        del pos_d
    res["deposit_twice"] = dict(ms=deposit_ms,
                                equal=bool(torch.equal(counts, again)))
    check(res["deposit_twice"]["equal"], "THREEDPOT: two grid deposits of "
          "one snapshot differ")
    del again
    total = float(counts.double().sum())
    res["deposit_total"] = total
    check(abs(total - TDP_PARTICLES) / TDP_PARTICLES < TDP_DEPOSIT_BOUND,
          f"THREEDPOT deposit total {total!r} of {TDP_PARTICLES}")
    mp = RHO_CRIT * 0.3 * TDP_BOX ** 3 / TDP_PARTICLES
    pot = {}
    for label, c, n in (("card", counts, TDP_NFFT),
                        ("card_coarse", coarse, TDP_CPU_NFFT),
                        ("cpu", coarse.cpu(), TDP_CPU_NFFT)):
        p32 = fftpot.potential_from_counts(c, n, TDP_BOX, 1.0, mp)
        p64 = fftpot.solve_potential(c.double(), n, TDP_BOX, 1.0, mp,
                                     torch.float64)
        pot[label] = max_rel(p32, p64)
        check(bool(torch.isfinite(p32).all()), f"{label} potential")
        del p32, p64
    res["potential"] = pot
    check(pot["card"] <= TDP_F64_FACTOR * pot["card_coarse"],
          f"THREEDPOT float32 potential {pot['card']:.3e} from float64 on "
          f"the card at NFFT {TDP_NFFT}, {pot['card_coarse']:.3e} at "
          f"{TDP_CPU_NFFT} ({pot['cpu']:.3e} on the CPU)")
    del counts, coarse
    gc.collect()
    torch.cuda.empty_cache()
    return res


def threedpot_trace(tmp):
    """The card-vs-CPU THREEDPOT trace (TDP_TRACE, float32): two snapshots,
    the second in two files; the packed rays within TRACE_BOUND of each
    quantity's max after every plane; each driver built each grid once."""
    from calclens_tpu_torch import fftpot
    from calclens_tpu_torch.cosmology import Cosmology
    from calclens_tpu_torch.driver import Raytracer, plane_params

    T = TDP_TRACE
    cosmo = Cosmology(0.3)
    stems = []
    for k, chi in enumerate(T["snap_chi"]):
        stem = os.path.join(tmp, f"snap_{k}")
        write_lgadget(stem, clumpy_snapshot(T["particles"], T["box"], 20 + k,
                                            T["clumps"]),
                      T["box"], float(cosmo.acomvdist(chi)), k + 1)
        stems.append(stem)
    lst = os.path.join(tmp, "trace.txt")
    with open(lst, "w") as fp:
        fp.write("\n".join(stems) + "\n")
    cfg = threedpot_config(lst, T["ray_order"], T["nfft"], T["max_dist"],
                           T["planes"])
    cpu = Raytracer(cfg, device="cpu")
    gpu = Raytracer(cfg, device="cuda")
    for rt in (cpu, gpu):
        rt.init_rays()
    errs = []
    for p in range(T["planes"]):
        cpu.step(p)
        gpu.step(p)
        errs.append(grouped_row_err(gpu.rays_packed.cpu(), cpu.rays_packed))
    snaps = [fftpot.nearest_snap(gpu.threedpot.snaps,
                                 plane_params(cfg, cosmo, p).rad)
             for p in range(T["planes"])]
    check(snaps[0] != snaps[-1], f"THREEDPOT trace snapshots {snaps}")
    check(cpu.threedpot.builds == gpu.threedpot.builds == 2,
          f"THREEDPOT trace builds {cpu.threedpot.builds}, "
          f"{gpu.threedpot.builds}")
    check(max(errs) < TRACE_BOUND,
          f"THREEDPOT trace, CUDA vs CPU: {errs}")
    return dict(errs=errs, snaps=snaps, nrays=gpu.rays_packed.shape[1])


def threedpot_phase(ref_dir=None):
    """Phase 14: the full-width run (in ref_dir, where its snapshot and
    phase 17's reference stay, when given) and the card-vs-CPU trace, each
    temporary directory deleted at its end."""
    import tempfile

    if ref_dir is not None:
        full = threedpot_full(ref_dir, keep_refs=True)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            full = threedpot_full(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        trace = threedpot_trace(tmp)
    return dict(full=full, trace=trace)


def report_threedpot(r, card):
    f = r["full"]
    times = f["times"]
    med = float(np.median(times[1:]))
    say(f"phase 14 ({card}): THREEDPOT NFFT {TDP_NFFT}, rayOrder "
        f"{TDP_RAY_ORDER} ({f['nrays']} rays), {TDP_PARTICLES} particles in "
        f"2 LGadget files ({f['snapshot_bytes']} bytes, made and written in "
        f"{f['snapshot_s']:.2f} s), {TDP_PLANES} planes of "
        f"{TDP_MAX_DIST / TDP_PLANES:g} Mpc/h, nint {f['fields']['nint']}, "
        f"float32: first plane (with the grid build) {times[0]:.4f} s at "
        f"{f['radii'][0]:.1f} Mpc/h, median of planes 1-{TDP_PLANES - 1} "
        f"{med:.4f} s/plane ({f['nrays'] / med:.0f} rays/s), plane "
        f"{len(times) // 2} {times[len(times) // 2]:.4f} s at "
        f"{f['radii'][len(times) // 2]:.1f}, last {times[-1]:.4f} s at "
        f"{f['radii'][-1]:.1f}; all {sum(times):.2f} s; peak "
        f"{f['peak'] / 2**30:.2f} GiB")
    pm = f["part_ms"]
    say("phase 14: plane 0 by parts (CUDA events): "
        + ", ".join(f"{t} {pm[t]:.2f} ms" for t in TDP_PARTS)
        + f"; grid build (read, upload, deposit, solve) "
        f"{sum(pm[t] for t in TDP_PARTS[:4]) / 1e3:.4f} s")
    for b in f["builds"]:
        say(f"phase 14: grid build with cuFFT's plan cache "
            f"{'cleared' if b['cleared'] else 'as it is'} ({b['plans_before']}"
            f" plans before, {b['plans_after']} after): {b['s']:.4f} s, peak "
            f"{b['peak'] / 2**30:.2f} GiB allocated; device memory outside "
            f"PyTorch's allocator after it {b['outside'] / 2**30:.2f} GiB; "
            f"the grid equal to the first build's bit for bit {b['equal']}")
    d = f["deposit_twice"]
    say(f"phase 14 ({card}): the grid deposit at NFFT {TDP_NFFT} of both "
        f"files twice: " + ", ".join(f"{t:.2f}" for t in d["ms"])
        + f" ms (plane 0's DEPOSIT part {pm['DEPOSIT']:.2f} ms; "
        f"{BEFORE_TDP_DEPOSIT_MS:.2f} ms before the fixed-order sums), equal "
        f"bit for bit {d['equal']}; the last plane twice from the same rays ("
        + ", ".join(f"{t:.4f}" for t in f["repeat"]["s"])
        + f" s): rays equal bit for bit {f['repeat']['equal']}")
    fl = f["fields"]
    say(f"phase 14: fields of {TDP_CHECK_RAYS} rays at {fl['rad']:.1f} Mpc/h, "
        f"float32 vs float64, card | CPU (same grid and rays; bound "
        f"{TDP_F64_FACTOR:g}x the CPU's): "
        + ", ".join(f"{q} {fl['card'][q]:.3e} | {fl['cpu'][q]:.3e}"
                    for q in fl["card"])
        + f"; float32 card vs CPU {fl['card_vs_cpu']:.3e}; the CPU's two "
        f"samplings {f['fields_cpu_s']:.2f} s")
    say(f"phase 14: deposit total {f['deposit_total']!r} of {TDP_PARTICLES} "
        f"(bound {TDP_DEPOSIT_BOUND:g}); float32 potential vs float64 of the "
        f"same counts: card NFFT {TDP_NFFT} {f['potential']['card']:.3e} "
        f"(bound {TDP_F64_FACTOR:g}x the card's at NFFT {TDP_CPU_NFFT}, "
        f"{f['potential']['card_coarse']:.3e}); CPU NFFT {TDP_CPU_NFFT} "
        f"{f['potential']['cpu']:.3e}")
    t = r["trace"]
    say(f"phase 14: THREEDPOT trace order {TDP_TRACE['ray_order']} "
        f"({t['nrays']} rays), NFFT {TDP_TRACE['nfft']}, f32, CUDA vs CPU per "
        f"plane: {', '.join(f'{e:.3e}' for e in t['errs'])} (bound "
        f"{TRACE_BOUND:g}); snapshot per plane {t['snaps']}")


# phase 15, the j-block streamed synthesis and the order-13 step: block
# counts timed per order (the first at each order is the unstreamed
# synthesis where it fits), the order-13 configuration (SHTOrder, rayOrder)
# with its particles per plane, the m rows of its kernel checks and the
# ring-pair windows (first, middle, last of the default count) on which K2
# is held to its twin; the point-mass plane and the galaxy run's sources
STREAM_COUNTS = {12: (1, 8, 32), 13: (16, 32)}
# the streamed synthesis against the unstreamed one (at order 13, where the
# unstreamed one does not fit, against the default count), relative to
# each map's max: the kernel-vs-twin bound
STREAM_BOUND = 1e-5
# the default count may lie this far above the fastest one measured (noise
# between calls: at order 12 the unstreamed synthesis and 8 blocks swapped
# places by up to 6 % in three calls on one card)
STREAM_DEFAULT_SLACK = 0.15
# K3 (synth_kernel "k3") through the streamed synthesis at this order and
# count (the JAX package's count from order 12), each window with its own
# seed pre-pass, against K3's unstreamed synthesis on the same alm
K3_STREAM = (12, 32)
O13_ORDERS = (13, 12)
O13_PARTICLES = 1 << 24
O13_CHECK_ROWS = (0, 1, 2, 3, 1023, 4096, 12287, 20001, 24575)
# the point mass (tests/test_torch_raytrace.py's: 5e16 Msun/h at ra 32,
# dec 14, 625 Mpc/h), its rays sampled every O13_PM_STRIDE-th, held at
# 0.15-0.6 rad to alpha_exact: median relative error and the median cosine
# of alpha with the direction to the mass
O13_PM = dict(partMass=5.0e16, ra=32.0, dec=14.0, rad=625.0)
O13_PM_STRIDE = 64
O13_PM_ERR = 0.02
O13_PM_COS = 0.999
# run() over two planes of 250 Mpc/h, the sources in plane 1's bin
O13_GALS = 10**6
O13_GALS_RADII = (255.0, 495.0)


def random_alm(plan, seed):
    """Band-limited random alm [nl, nm] on the plan's device from a torch
    generator seeded `seed`, with a red spectrum (1 + l)^-1.5, real at m =
    0: made on the card (at order 13 a host draw takes ~10 s)."""
    import torch

    g = torch.Generator(device=plan.device).manual_seed(seed)
    re = torch.randn((plan.nl, plan.nm), generator=g, device=plan.device)
    im = torch.randn((plan.nl, plan.nm), generator=g, device=plan.device)
    l = torch.arange(plan.nl, device=plan.device)[:, None]
    m = torch.arange(plan.nm, device=plan.device)[None, :]
    w = torch.where(m <= l, (1.0 + l.float()) ** -1.5, 0.0)
    im[:, 0] = 0.0
    return torch.complex(re * w, im * w)


def map_rel_errs(got, ref):
    """Max over the rows of [k, npix] maps of max |got - ref| / max |ref|."""
    return max(rel_err(got[i], ref[i]) for i in range(ref.shape[0]))


def stream_counts(order, dev):
    """The synthesis at each candidate block count on one alm, into one
    output buffer: maps against the first count's (the unstreamed synthesis
    where the order has it, at order 13 the default count's, made first),
    CUDA-event ms of a second call, peak memory of the first above the
    alm, the buffer and the reference maps."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.plan import SHTPlan

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    plan = SHTPlan(order, dev, dtype=torch.float32)
    alm = random_alm(plan, 150 + order)
    default = T.synth_stream_blocks(plan)
    counts = STREAM_COUNTS[order]
    ref_count = counts[0] if counts[0] == 1 else default
    order_counts = [ref_count] + [c for c in counts if c != ref_count]
    out = torch.empty((6, plan.npix), dtype=plan.dtype, device=plan.device)
    ref, rows = None, {}
    for nblk in order_counts:
        plan.synth_stream = nblk
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _ext.reset_launches()
        _, first_ms = timed_once(lambda: T.alm2allmaps(plan, alm, out=out))
        launches = _ext.launches["legendre_synth"]
        peak = torch.cuda.max_memory_allocated() - base
        check(launches == nblk, f"order {order}, {nblk} blocks: K2 launched "
              f"{launches} times")
        if ref is None:
            err = 0.0
            ref = out.clone()
        else:
            err = map_rel_errs(out, ref)
        _, ms = timed_once(lambda: T.alm2allmaps(plan, alm, out=out))
        check(bool(torch.isfinite(out).all()) and err < STREAM_BOUND,
              f"order {order}, {nblk} blocks: maps {err:.3e} off "
              f"{ref_count} blocks")
        rows[nblk] = dict(err=err, ms=ms, first_ms=first_ms, peak=peak)
    res = dict(rows=rows, ref=ref_count, default=default, resident=resident)
    if order == K3_STREAM[0]:
        res["k3"] = k3_streamed(plan, alm, out)
    del plan, alm, out, ref
    torch.cuda.empty_cache()
    return res


def k3_streamed(plan, alm, out):
    """K3 through alm2allmaps on one alm, unstreamed and at K3_STREAM's
    count of j-blocks: per count the launches of K3 and its seed pre-pass
    (exactly one each per block), the maps against the unstreamed ones
    within STREAM_BOUND of each map's max, CUDA-event ms of a second call.
    The plan is left with K2 and its default count."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.sht import transforms as T

    plan.synth_kernel = "k3"
    ref, res = None, {}
    for nblk in (1, K3_STREAM[1]):
        plan.synth_stream = nblk
        _ext.reset_launches()
        T.alm2allmaps(plan, alm, out=out)
        launches = {k: v for k, v in _ext.launches.items() if v}
        want = {"legendre_synth_vpu": nblk, "legendre_chain_seed": nblk}
        check(launches == want, f"K3 at {nblk} blocks launched {launches}, "
              f"expected {want}")
        err = 0.0 if ref is None else map_rel_errs(out, ref)
        if ref is None:
            ref = out.clone()
        check(bool(torch.isfinite(out).all()) and err < STREAM_BOUND,
              f"K3 at {nblk} blocks: maps {err:.3e} off unstreamed K3")
        _, ms = timed_once(lambda: T.alm2allmaps(plan, alm, out=out))
        res[nblk] = dict(err=err, ms=ms, launches=launches)
    plan.synth_kernel, plan.synth_stream = "k2", None
    del ref
    torch.cuda.empty_cache()
    return res


def order13_kernels(rt):
    """K1, K4 and K2 at order 13 on the plane step's plan: K1 on the
    folded ring sums of a band-limited potential (all rings), K2 on the
    ring-pair windows of the first (polar) and the last (equatorial) block
    of the default count, each against its twin on O13_CHECK_ROWS (~14 s
    per twin: a loop over 24,576 degrees); K4 against K1 on the same
    inputs; K1's and K4's ms and K2's ms summed over every block of a
    synthesis (CUDA events); every kernel launched twice on the same
    inputs (the synthesis kernels on the first window), and K1 and K4 on a
    block of m rows (kernels_twice, block_rows)."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.tools import cuda_ms

    plan = rt.plan
    m = torch.tensor(O13_CHECK_ROWS, device=plan.device)
    alm = random_alm(plan, 13)
    streams = T.synthesis_streams(plan, alm, True)
    nblk = T.synth_stream_blocks(plan)
    jb = plan.J // nblk
    starts = (0, plan.J - jb)
    k2 = {}
    t0 = time.perf_counter()
    for j0 in starts:
        win = plan.window(j0, j0 + jb)
        geo = (win.cth, win.ln_sth, win.logc, win.mcut(TL.SYNTH_TILE_J))
        got = TL.synth_cuda(streams, *geo)[m]
        ref = TL.synth_plain(tuple(s[m] for s in streams), win.cth,
                             win.ln_sth, win.logc[m], geo[3], m=m)
        k2[j0] = col_errs(got, ref)
    k2_twin_s = time.perf_counter() - t0
    wins = [plan.window(j, j + jb) for j in range(0, plan.J, jb)]
    geos = [(w.cth, w.ln_sth, w.logc, w.mcut(TL.SYNTH_TILE_J)) for w in wins]
    k2_ms = sum(cuda_ms(lambda g=g: TL.synth_cuda(streams, *g), 1)
                for g in geos)
    phi = T.alm2allmaps(plan, alm)[0]
    del alm
    tables = analysis_phase_table(plan, phi)
    E, O = T.fold_pairs(plan, T.analysis_rings(plan, phi))
    del phi
    ana = TL.analysis_inputs(plan, E, O)
    del E, O
    # K1 and K4 (warm from the step's planes): one timed launch each, then
    # one more each to compare bits
    got, k1_ms = timed_once(lambda: TL.analysis_cuda(*ana, plan.nl))
    t0 = time.perf_counter()
    ref = TL.analysis_plain(*(x[m] for x in ana[:4]), plan.cth, plan.ln_sth,
                            plan.logc[m], ana[7], plan.nl, m=m)
    k1_twin_s = time.perf_counter() - t0
    k1 = pair_errs(tuple(x[m] for x in got), ref)
    got4, k4_ms = timed_once(lambda: TL.analysis_dot_cuda(*ana, plan.nl))
    k4 = pair_errs(got4, got)
    full = {"legendre_analysis": got, "legendre_analysis_dot": got4}
    twice = {name: all(torch.equal(x, y) for x, y in zip(
        full[name], fn(*ana, plan.nl))) for name, fn in (
        ("legendre_analysis", TL.analysis_cuda),
        ("legendre_analysis_dot", TL.analysis_dot_cuda))}
    torch.cuda.empty_cache()
    twice.update(kernels_twice(wins[0], streams, ana, analysis=False))
    rows, m_block = block_rows(plan, None, ana, full)
    del ana, streams, got, got4, full
    torch.cuda.empty_cache()
    return dict(k1=k1, k1_ms=k1_ms, k1_twin_s=k1_twin_s, k2=k2, k2_ms=k2_ms,
                k2_twin_s=k2_twin_s, nblk=nblk, jb=jb, tables=tables, k4=k4,
                k4_ms=k4_ms, twice=twice, rows=rows, m_block=m_block)


def analysis_phase_table(plan, phi):
    """The analysis ring stage at order 13 as the plan runs it (its
    [nrings_pad, nm] phase table above the TableCache's limit, applied in
    row blocks) and with that table kept: CUDA-event ms of a call after a
    warm-up, its peak memory above what was allocated before it, the
    table's bytes; the kept table is dropped after."""
    import torch
    from calclens_tpu_torch.sht import transforms as T

    out = {}
    limit = plan.tables.max_bytes
    for kept in (False, True):
        plan.tables.max_bytes = None if kept else limit
        T.analysis_rings(plan, phi)  # warm-up; builds the table when kept
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, ms = timed_once(lambda: T.analysis_rings(plan, phi))
        out[kept] = dict(ms=ms, peak=torch.cuda.max_memory_allocated() - base)
    out["bytes"] = plan.tables.nbytes("phase_analysis")
    plan.tables.max_bytes = limit
    plan.tables._tables.pop(("phase_analysis",), None)
    torch.cuda.empty_cache()
    return out


def order13_pointmass(rt, plane):
    """One point mass (O13_PM, snapped to its SHTOrder pixel centre) on
    the order-13 Raytracer, from fresh rays, with the point-mass radial
    convention (PointMassTest): alpha of every O13_PM_STRIDE-th ray at
    0.15-0.6 rad from the mass against pointmass.alpha_exact (median
    relative error) and its direction against the direction to the mass
    at 0.1-0.4 rad (median cosine), as tests/test_torch_raytrace.py holds
    the order-7 trace."""
    import torch
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.healpix import core as hp
    from calclens_tpu_torch.testing import pointmass as pmt

    cfg = rt.cfg
    cfg.PointMassTest, cfg.partMass = True, O13_PM["partMass"]
    pp = plane_params(cfg, rt.cosmo, plane)
    check(abs(pp.rad - O13_PM["rad"]) < 1e-9, f"plane {plane} at {pp.rad}")
    theta, phi = hp.radec2ang(O13_PM["ra"], O13_PM["dec"])
    pix = hp.ang2pix_ring(theta, phi, cfg.SHTOrder)
    vec = hp.pix2vec_ring(pix, cfg.SHTOrder)
    rt.init_rays()
    t0 = time.perf_counter()
    rt.step(plane, pos=vec[None, :] * pp.rad, mass=[cfg.partMass])
    step_s = time.perf_counter() - t0
    cfg.PointMassTest = False
    sub = rt.rays_packed[:, ::O13_PM_STRIDE].double().cpu().numpy()
    check(np.all(np.isfinite(sub)), "point-mass plane: non-finite rays")
    n = sub[0:3].T
    nhat = n / np.linalg.norm(n, axis=1, keepdims=True)
    alpha = sub[14:16].T
    gamma = np.arccos(np.clip(nhat @ vec, -1.0, 1.0))
    q = pmt.charge(cfg, rt.cosmo, pp.rad)
    amag = np.linalg.norm(alpha, axis=1)
    sel = (gamma > 0.15) & (gamma < 0.6)
    ex = pmt.alpha_exact(gamma[sel], q)
    err = np.abs(amag[sel] - ex) / ex
    phihat = np.stack([-nhat[:, 1], nhat[:, 0], np.zeros(len(nhat))], 1)
    phihat /= np.linalg.norm(phihat, axis=1, keepdims=True)
    thetahat = np.cross(phihat, nhat)
    thetahat /= np.linalg.norm(thetahat, axis=1, keepdims=True)
    avec = alpha[:, :1] * thetahat + alpha[:, 1:2] * phihat
    tomass = vec[None, :] - nhat * (nhat @ vec)[:, None]
    tomass /= np.linalg.norm(tomass, axis=1, keepdims=True)
    sel2 = (gamma > 0.1) & (gamma < 0.4)
    cosang = np.sum(avec[sel2] * tomass[sel2], axis=1) \
        / np.linalg.norm(avec[sel2], axis=1)
    res = dict(median_err=float(np.median(err)),
               p95_err=float(np.percentile(err, 95)), nsel=int(sel.sum()),
               cos=float(np.median(cosang)), step_s=step_s)
    check(res["median_err"] < O13_PM_ERR and res["cos"] > O13_PM_COS,
          f"order-13 point mass: {res}")
    torch.cuda.empty_cache()
    return res


def order13_step():
    """The order-13 configuration through Raytracer.step: the plan's and
    the rays' build seconds, one warm-up plane, one timed with Profile set
    (with each phase's peak memory),
    each plane's launches exact (K1 once, K2 once per block), the peak
    memory after a reset under DEVICE_MEMORY; then K1 and K2 at order 13
    against their twins (order13_kernels) and the point-mass plane."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.sht import transforms as T

    sht, ray = O13_ORDERS
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=sht, rayOrder=ray, bundleOrder=3,
                         Precision="f32").finalize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.init_rays()
    torch.cuda.synchronize()
    rays_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    nblk = T.synth_stream_blocks(rt.plan)
    want = {"legendre_analysis": 1, "legendre_synth": nblk}
    pos, mass = seeded_particles(O13_PARTICLES, 1.0, 13)
    staged = {p: rt.stage_particles(pos * (250.0 * p + 125.0), mass)
              for p in (1, 2)}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    # plane 1 a warm-up, plane 2 timed with Profile set, the peak of each
    # of its phases taken apart
    phase_peaks = {}
    between = [0]  # the peak outside the phases
    timed_phase = rt._timed_phase

    def peak_phase(plane_num):
        inner = timed_phase(plane_num)

        def phase(tag, fn, *args):
            between[0] = max(between[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out_ = inner(tag, fn, *args)
            phase_peaks[tag] = torch.cuda.max_memory_allocated()
            return out_

        return phase

    times, plane_counts = [], []
    for p in (1, 2):
        if p == 2:
            rt._timed_phase = peak_phase
            rt.cfg.Profile = True
        before = dict(_ext.launches)
        t = time.perf_counter()
        rt.step(p, *staged[p])
        times.append(time.perf_counter() - t)
        counts = {k: v - before[k] for k, v in _ext.launches.items()
                  if v - before[k]}
        check(counts == want, f"order-13 plane {p} launched {counts}, "
              f"expected {want}")
        plane_counts.append(counts)
    rt.cfg.Profile = False
    rt._timed_phase = timed_phase
    peak = max(between[0], torch.cuda.max_memory_allocated(),
               *phase_peaks.values())
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "order-13 step: non-finite rays")
    check(peak < DEVICE_MEMORY, f"order-13 step peak {peak / 1e9:.1f} GB")
    row = dict(rt.phase_rows)[2]
    profile = (rt.timings[-1][1], row, phase_peaks)
    check(sorted(row) == sorted(PROFILE_TAGS), f"Profile'd plane: {row}")
    del staged
    nrays = rt.rays_packed.shape[1]
    rt.rays_packed = None
    torch.cuda.empty_cache()
    kern = order13_kernels(rt)
    pmass = order13_pointmass(rt, 2)
    out = dict(plan_s=plan_s, rays_s=rays_s, setup_peak=setup_peak,
               times=times, warm=times[0], nrays=nrays, peak=peak,
               resident=resident, counts=plane_counts, nblk=nblk,
               profile=profile, kernels=kern, pm=pmass,
               tables=rt.plan.tables.nbytes())
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def order13_gals(tmp):
    """Raytracer.run at the order-13 shape over two planes of 250 Mpc/h
    with Profile on, O13_PARTICLES per plane through load_particles,
    GalsFileList naming O13_GALS sources in plane 1's bin (write_catalog)
    and GalOutputName set: every source imaged (plane 1's catalog read
    back), gals/s of the plane's GRIDSEARCH column, each plane's launches,
    the run's peak memory.  The run's closing restart (the 16.9 GB ray
    buffer to an npz file) is left out."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.gals import io as galsio
    from calclens_tpu_torch.sht import transforms as T

    glist, _ = write_catalog(f"{tmp}/sources13", O13_GALS, 41,
                             *O13_GALS_RADII)
    sht, ray = O13_ORDERS
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=500.0, NumLensPlanes=2,
                         SHTOrder=sht, rayOrder=ray, bundleOrder=3,
                         Precision="f32", Profile=True, GalsFileList=glist,
                         GalOutputName="gal_",
                         OutputPath=f"{tmp}/run13").finalize()
    gc.collect()
    torch.cuda.empty_cache()
    rt = Raytracer(cfg, device="cuda")
    pos, mass = seeded_particles(O13_PARTICLES, 1.0, 14)
    rt.load_particles = lambda p: (pos * (250.0 * p + 125.0), mass)
    rt.save_restart = lambda path=None: None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    t0 = time.perf_counter()
    rt.run(progress=False)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in _ext.launches.items() if v}
    nblk = T.synth_stream_blocks(rt.plan)
    want = {"legendre_analysis": 2, "legendre_synth": 2 * nblk}
    check(launches == want, f"order-13 run() launched {launches}, expected "
          f"{want}")
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "order-13 run(): non-finite rays")
    idx = galsio.read_image_gals(os.path.join(cfg.OutputPath,
                                              "gal_0001.0000.fit"))["index"]
    imaged = int((np.bincount(idx, minlength=O13_GALS) > 0).sum())
    check(imaged == O13_GALS, f"order-13 run(): {imaged} of {O13_GALS} "
          f"sources imaged")
    rows = dict(rt.phase_rows)
    gs_s = rows[1]["GRIDSEARCH"]
    out = dict(run_s=run_s, peak=peak, launches=launches, images=len(idx),
               imaged=imaged, gridsearch_s=gs_s, gals_per_s=O13_GALS / gs_s,
               steps=[t for _, t in rt.timings], rows=rows, nblk=nblk)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stream_phase(dev, card):
    """Phase 15: block counts per order (stream_counts), the order-13 step
    (order13_step) and run() with galaxies (order13_gals); prints them."""
    import tempfile

    t_phase = time.perf_counter()
    s = order13_step()
    times = s["times"]
    med = float(np.median(times[1:]))
    say(f"phase 15 ({card}): SHTOrder {O13_ORDERS[0]} / rayOrder "
        f"{O13_ORDERS[1]} ({s['nrays']} rays), {O13_PARTICLES} particles, "
        f"f32, NGP, {s['nblk']} j-blocks: plan {s['plan_s']:.3f} s, rays "
        f"{s['rays_s']:.3f} s (peak {s['setup_peak'] / 2**30:.2f} GiB); "
        f"warm-up plane {times[0]:.4f} s, timed "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s: {med:.4f} s/plane, "
        f"{s['nrays'] / med:.0f} rays/s; peak {s['peak'] / 2**30:.2f} GiB "
        f"({s['resident'] / 2**30:.2f} resident); launches per plane "
        f"{s['counts'][0]}; plan tables {s['tables'] / 2**30:.3f} GiB")
    step_s, row, phase_peaks = s["profile"]
    say(f"phase 15: Profile'd plane {step_s:.4f} s: "
        + ", ".join(f"{k} {row[k]:.4f}" for k in PROFILE_TAGS)
        + "; peak GiB per phase: " + ", ".join(
            f"{k} {phase_peaks[k] / 2**30:.2f}" for k in PROFILE_TAGS))
    k = s["kernels"]
    say(f"phase 15: order 13 K1 legendre_analysis {k['k1_ms']:.2f} ms, rows "
        f"{O13_CHECK_ROWS} rel {k['k1'][0]:.3e} abs {k['k1'][1]:.3e} (bound "
        f"{K1_BOUND:g}; twin {k['k1_twin_s']:.1f} s); K2 legendre_synth "
        f"{k['k2_ms']:.2f} ms over {k['nblk']} windows of {k['jb']} ring "
        f"pairs; windows from "
        + ", ".join(f"{j0}: rel {e[0]:.3e} abs {e[1]:.3e}"
                    for j0, e in k["k2"].items())
        + f" (bound {K2_BOUND:g}; twins {k['k2_twin_s']:.1f} s)")
    t = k["tables"]
    say(f"phase 15: order 13 analysis ring stage with its phase table "
        f"applied in row blocks {t[False]['ms']:.2f} ms (peak "
        f"{t[False]['peak'] / 2**30:.2f} GiB above the map), with the table "
        f"kept ({t['bytes'] / 2**30:.2f} GiB) {t[True]['ms']:.2f} ms (peak "
        f"{t[True]['peak'] / 2**30:.2f} GiB)")
    check(k["k1"][0] < K1_BOUND and all(e[0] < K2_BOUND
                                        for e in k["k2"].values()),
          f"order-13 kernels off their twins: {k}")
    say(f"phase 15: order 13 K4 legendre_analysis_dot {k['k4_ms']:.2f} ms, "
        f"vs K1 on the same inputs rel {k['k4'][0]:.3e} abs "
        f"{k['k4'][1]:.3e} (bound {VARIANT_BOUND:g})")
    check(k["k4"][0] < VARIANT_BOUND, f"order-13 K4 off K1: {k['k4']}")
    report_bits("phase 15: order 13 kernels (the synthesis kernels on the "
                "first window)", k["twice"], k["rows"], k["m_block"])
    p = s["pm"]
    say(f"phase 15: order-13 point mass: alpha at 0.15-0.6 rad ({p['nsel']} "
        f"rays) median error {p['median_err']:.4f} (bound {O13_PM_ERR:g}), "
        f"95th percentile {p['p95_err']:.4f}; direction cosine median "
        f"{p['cos']:.6f} (bound {O13_PM_COS:g}); step {p['step_s']:.3f} s")
    with tempfile.TemporaryDirectory() as tmp:
        g = order13_gals(tmp)
    say(f"phase 15: run() at order 13 / {O13_ORDERS[1]}, 2 planes, "
        f"{O13_GALS} sources in plane 1's bin: every source imaged "
        f"({g['images']} images), GRIDSEARCH {g['gridsearch_s']:.3f} s "
        f"({g['gals_per_s']:.0f} gals/s), steps "
        f"{', '.join(f'{t:.3f}' for t in g['steps'])} s, run "
        f"{g['run_s']:.2f} s, peak {g['peak'] / 2**30:.2f} GiB, launches "
        f"{g['launches']}")
    check(g["peak"] < DEVICE_MEMORY, f"order-13 run() peak {g['peak']}")
    counts = {}
    for order in sorted(STREAM_COUNTS):
        r = stream_counts(order, dev)
        counts[order] = r
        best = min(r["rows"], key=lambda c: r["rows"][c]["ms"])
        say(f"phase 15 ({card}): order {order} synthesis by j-blocks, ms "
            f"(first call ms, peak GiB above the inputs, maps vs "
            f"{r['ref']} block(s)): " + "; ".join(
                f"{c}: {v['ms']:.2f} ({v['first_ms']:.1f}, "
                f"{v['peak'] / 2**30:.2f}, {v['err']:.3e})"
                for c, v in sorted(r["rows"].items()))
            + f" (bound {STREAM_BOUND:g}); fastest {best}, default "
            f"{r['default']}; {r['resident'] / 2**30:.2f} GiB allocated "
            f"before")
        if "k3" in r:
            say(f"phase 15: order {order} K3 legendre_synth_vpu through the "
                f"synthesis, ms (launches, maps vs 1 block): " + "; ".join(
                    f"{c} block(s): {v['ms']:.2f} ({v['launches']}, "
                    f"{v['err']:.3e})" for c, v in r["k3"].items())
                + f" (bound {STREAM_BOUND:g})")
        dms = r["rows"][r["default"]]["ms"]
        check(dms <= (1.0 + STREAM_DEFAULT_SLACK) * r["rows"][best]["ms"],
              f"order {order}: default {r['default']} blocks {dms:.2f} ms, "
              f"fastest {best} {r['rows'][best]['ms']:.2f} ms")
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, step=s, gals=g)


# ----------------------------------------------------------------------------
# phase 16: the multi-device path (calclens_tpu_torch/parallel/) on ranks
# that share the card
# ----------------------------------------------------------------------------

# the headline over ranks sharing the card: SHTOrder 12 / rayOrder 10, 2^21
# particles, f32, NGP, one warm-up plane and one timed plane; its rays'
# A and alpha against the one-rank step's within P16_HEAD_BOUNDS of each
# quantity's max, its order-8 lens map counts exact.  Both runs sum in a
# fixed order, so the distance is the same on every run: 8.987e-05 (A) and
# 1.374e-03 (alpha, the polar rays) on an H100, 700 W, where K1's ring
# tiles added with atomicAdd allowed 1e-2; about 3x those readings
P16_HEAD_RANKS = 2
P16_HEAD_PLANES = (2, 3)
P16_HEAD_BOUNDS = {"A": 3e-4, "alpha": 4e-3}
# the small-order traces: ranks, planes, particles and sources per case
P16_TRACE_RANKS = (2, 4)
P16_TRACE_PLANES = 2
P16_TRACE_PARTICLES = 20000
P16_TRACE_GALS = 2000
# K1-K4 launched on a block of m rows (the m0 argument) against the whole
# launch's rows at this order
P16_ROWS_ORDER = 10
# seconds a set of ranks may take before all are killed
P16_TIMEOUT = 600.0
# the collectives every Mesh method goes through
MESH_PRIMITIVES = ("all_to_all", "reduce_scatter", "all_gather")
# the Mesh methods each collective goes through, timed between two syncs
MESH_COLLECTIVES = ("exchange", "reduce_scatter_blocks",
                    "reduce_scatter_rows", "all_gather_cols",
                    "all_gather_rows", "all_true")


def sent_bytes(name, n, rank, args):
    """The bytes this rank sends to the others in one call of the Mesh
    method `name`, from its arguments' shapes: the pieces for the other
    ranks of an exchange, (n - 1) / n of a reduce-scatter's input, an
    all-gather's block to each of the n - 1 others."""
    import torch

    if name == "exchange":
        send, _, dtype = args
        size = torch.empty((), dtype=dtype).element_size()
        return sum(int(x.numel()) for d, x in enumerate(send)
                   if d != rank) * size
    x = args[0]
    nbytes = x.numel() * x.element_size()
    if name.startswith("reduce_scatter"):
        return nbytes * (n - 1) // n
    return nbytes * (n - 1)


def time_collectives(mesh):
    """Wrap mesh's collective methods: each call timed on the host between
    two device syncs and its bytes sent counted; returns the dict
    {method: [seconds, bytes, calls]} they add to (untime_collectives
    removes the wrappers)."""
    import torch

    spent = {}
    for name in MESH_COLLECTIVES:
        def synced(*a, _fn=getattr(mesh, name), _name=name):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = _fn(*a)
            torch.cuda.synchronize()
            row = spent.setdefault(_name, [0.0, 0, 0])
            row[0] += time.perf_counter() - t
            row[1] += sent_bytes(_name, mesh.size, mesh.rank, a)
            row[2] += 1
            return res
        setattr(mesh, name, synced)
    return spent


def untime_collectives(mesh):
    """The Mesh's own collective methods again."""
    if mesh is not None:
        for name in MESH_COLLECTIVES:
            mesh.__dict__.pop(name, None)


def p16_probe(mesh):
    """Which primitive gloo takes on CUDA tensors: name -> "ok" or the
    error (values checked; uneven all-to-all splits)."""
    import torch
    import torch.distributed as dist

    r, n, dev = mesh.rank, mesh.size, mesh.device
    out = {}

    def a2a():
        ins = [r + d + 1 for d in range(n)]
        outs = [s + r + 1 for s in range(n)]
        x = torch.cat([torch.full((k,), float(100 * r + d), device=dev)
                       for d, k in enumerate(ins)])
        y = torch.empty(sum(outs), device=dev)
        dist.all_to_all_single(y, x, outs, ins)
        want = torch.cat([torch.full((k,), float(100 * s + r), device=dev)
                          for s, k in enumerate(outs)])
        return torch.equal(y, want)

    def rs():
        x = torch.arange(4 * n, dtype=torch.float32, device=dev) + r
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, x)
        want = (torch.arange(4 * r, 4 * r + 4, dtype=torch.float32,
                             device=dev) * n + n * (n - 1) / 2)
        return torch.equal(y, want)

    def ag():
        x = torch.full((3,), float(r), device=dev)
        y = torch.empty(3 * n, device=dev)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y.cpu(), torch.arange(n, dtype=torch.float32
                                                 ).repeat_interleave(3))

    for name, fn in zip(MESH_PRIMITIVES, (a2a, rs, ag)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong values"
        except Exception as e:  # the probe's answer, not a failure
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    return out


def p16_nccl(mesh):
    """NCCL at world size 1: every Mesh collective returns its input, and
    the sharded 2-plane trace at order 7/6 equals the one-device trace on
    the same card within TRACE_BOUND (grouped_row_err per plane)."""
    import torch
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    check(mesh.backend == "nccl" and mesh.size == 1, f"{mesh}")
    x = torch.randn(3, 1000, device=mesh.device)
    c = torch.randn(2, 64, 32, dtype=torch.complex64, device=mesh.device)
    b = mesh.blocks(1000)
    ident = {
        "reduce_scatter_blocks": torch.equal(mesh.reduce_scatter_blocks(x),
                                             x),
        "all_gather_cols": torch.equal(mesh.all_gather_cols(x, b), x),
        "repartition": torch.equal(mesh.repartition(x, b, b), x),
        "window": torch.equal(mesh.window(x, b, 10)[0], x),
        "rings_to_m": torch.equal(mesh.rings_to_m(
            c, np.array([0, 64]), np.array([0, 32])), c),
        "gather_to": torch.equal(mesh.gather_to(x, [1000], 0), x)}
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=7, rayOrder=6, bundleOrder=3,
                         Precision="f32").finalize()
    one = Raytracer(cfg, device=mesh.device)
    sh = Raytracer(cfg, device=mesh.device, mesh=mesh)
    errs = []
    for rt in (one, sh):
        rt.init_rays()
    for p in range(P16_TRACE_PLANES):
        pos, mass = pixel_centre_particles(cfg, one.cosmo, p,
                                           P16_TRACE_PARTICLES, 100 + p)
        one.step(p, pos=pos, mass=mass)
        sh.step(p, pos=pos, mass=mass)
        errs.append(grouped_row_err(sh.rays_packed, one.rays_packed))
    return dict(identities=ident, errs=errs, calls=dict(mesh.calls))


def p16_trace_cases(mesh, device, tmp):
    """The small-order cases on `mesh` (None: one device): per case the
    whole rays after P16_TRACE_PLANES planes (host numpy) and each plane's
    launches on this rank; and Raytracer.run with lens maps, two ray files
    and galaxy images into <tmp>/<n ranks>/."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                SHTOrder=7, rayOrder=6, bundleOrder=3, Precision="f32")
    cases = {"NGP": ({}, {}), "SPH": (dict(DepositScheme="SPH"), {}),
             "4 blocks": ({}, dict(synth_stream=4)),
             "(k3, k4)": ({}, dict(synth_kernel="k3",
                                   analysis_kernel="k4"))}
    out = {}
    for label, (kw, plan_kw) in cases.items():
        cfg = RayTraceConfig(**base, **kw).finalize()
        rt = Raytracer(cfg, device=device, mesh=mesh)
        for k, v in plan_kw.items():
            setattr(rt.plan, k, v)
        rt.init_rays()
        counts = []
        for p in range(P16_TRACE_PLANES):
            pos, mass = pixel_centre_particles(cfg, rt.cosmo, p,
                                               P16_TRACE_PARTICLES, 100 + p)
            _ext.reset_launches()
            rt.step(p, pos=pos, mass=mass)
            counts.append({k: v for k, v in _ext.launches.items() if v})
        out[label] = (rt.packed_global().cpu().numpy(), counts)
        del rt
    n = 1 if mesh is None else mesh.size
    cfg = RayTraceConfig(**dict(base, NumLensPlanes=4,
                                maxComvDistance=1000.0),
                         MapRedshiftList=f"{tmp}/zs.txt", LensMapOrder=4,
                         RayOutputName="rays_", NumRayOutputFiles=2,
                         GalsFileList=f"{tmp}/gals.txt",
                         GalOutputName="gal_",
                         OutputPath=f"{tmp}/{n}").finalize()
    rt = Raytracer(cfg, device=device, mesh=mesh)
    rt.load_particles = lambda p: pixel_centre_particles(
        cfg, rt.cosmo, p, P16_TRACE_PARTICLES, 100 + p)
    _ext.reset_launches()
    rt.run(progress=False)
    out["run"] = (rt.packed_global().cpu().numpy(),
                  [{k: v for k, v in _ext.launches.items() if v}])
    torch.cuda.synchronize()
    return out


def p16_trace_rank(mesh, tmp):
    res = p16_trace_cases(mesh, mesh.device, tmp)
    res = {k: (v[0] if mesh.rank == 0 else None, v[1])
           for k, v in res.items()}
    return dict(cases=res, calls=dict(mesh.calls))


def p16_headline_run(mesh, device, planes, out_path):
    """The headline planes on `mesh` (None: one device): per plane the step
    seconds, this rank's launches and its K1 and K2 milliseconds (CUDA
    events around each call of the two wrappers); the peak memory; the
    order-8 lens map counts and the whole rays (written to out_path) on
    rank 0 or the one device.  On a mesh the last plane runs with Profile
    set and the collectives' host seconds, each between two device syncs,
    summed apart."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.sht import legendre as TL

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=12, rayOrder=10, bundleOrder=3,
                         Precision="f32").finalize()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device=device, mesh=mesh)
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pos, mass = seeded_particles(1 << 21, 1.0, 12)
    parts = {p: rt.stage_particles(pos * (250.0 * p + 125.0), mass)
             for p in planes}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    events = {"K1": [], "K2": []}
    kept = (TL.analysis_columns, TL.synth_columns)

    def timed(name, fn):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*a, **k)
            e1.record()
            events[name].append((e0, e1))
            return res
        return call

    TL.analysis_columns = timed("K1", kept[0])
    TL.synth_columns = timed("K2", kept[1])
    rows = []
    spent = {}
    try:
        for p in planes:
            if mesh is not None and p == planes[-1]:
                rt.cfg.Profile = True
                spent = time_collectives(mesh)
            for v in events.values():
                v.clear()
            _ext.reset_launches()
            t = time.perf_counter()
            rt.step(p, *parts[p])  # ends in torch.cuda.synchronize()
            dt = time.perf_counter() - t
            rows.append(dict(
                plane=p, s=dt,
                launches={k: v for k, v in _ext.launches.items() if v},
                **{f"{k}_ms": sum(a.elapsed_time(b) for a, b in v)
                   for k, v in events.items()}))
    finally:
        TL.analysis_columns, TL.synth_columns = kept
        untime_collectives(mesh)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(rt.rays_packed).all()), "non-finite rays")
    sums = rt._lens_map_sums(MAP_ORDER)
    rank = 0 if mesh is None else mesh.rank
    full = (rt.rays_packed if mesh is None else mesh.gather_to(
        rt.rays_packed, np.diff(rt.ray_bounds), 0))
    if rank == 0:
        np.save(out_path, full.cpu().numpy())
        sums = sums.cpu().numpy()[0]
    del full
    profile = None
    if mesh is not None:
        p = planes[-1]
        profile = (rt.timings[-1][1], dict(rt.phase_rows)[p],
                   sum(v[0] for v in spent.values()))
    del rt, parts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=rank, rows=rows, peak=peak, resident=resident,
                setup_s=setup_s, counts=sums if rank == 0 else None,
                m_rows=None if mesh is None else mesh.block(12288),
                profile=profile)


def p16_headline_rank(mesh, planes, out_path):
    """p16_probe, then the headline on this rank; a primitive that gloo
    refuses on CUDA tensors fails the rank."""
    probe = p16_probe(mesh)
    if any(v != "ok" for v in probe.values()):
        raise RuntimeError(f"gloo on CUDA tensors: {probe}")
    res = p16_headline_run(mesh, mesh.device, planes, out_path)
    res.update(calls=dict(mesh.calls), probe=probe)
    return res


def mesh_phase(dev, card, tmp):
    """Phase 16 (see the module docstring); prints and checks; returns the
    headline ranks' launches for the kernels line.  A generator for
    run_phases: it yields the parts its ranks run and takes their
    results."""
    import torch
    from calclens_tpu_torch import maps as tmaps

    t_phase = time.perf_counter()
    say(f"phase 16: torch.cuda.device_count() {torch.cuda.device_count()}; "
        f"ranks share card 0 over gloo ({card})")
    plan, _, streams, ana = band_limited_inputs(P16_ROWS_ORDER, dev, 16)
    krows, (m0, m1) = block_rows(plan, streams, ana)
    del plan, streams, ana
    say(f"phase 16: kernels on m rows [{m0}, {m1}) at order {P16_ROWS_ORDER} "
        f"vs the whole launch's rows: " + ", ".join(
            f"{k} rel {v[0]:.3e} abs {v[1]:.3e}" for k, v in krows.items()))
    check(all(v[1] == 0.0 for v in krows.values()),
          f"kernels on a block of m rows: {krows}")
    rank_dev = f"cuda:{dev.index or 0}"

    # NCCL at world size 1, in this process
    import torch.distributed as dist
    from calclens_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    try:
        nc = p16_nccl(make_mesh("nccl", f"file://{tmp}/nccl", 0, 1,
                                device=rank_dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"phase 16: NCCL world size 1: identities {nc['identities']}; "
        f"sharded trace order 7/6 vs one-device per plane "
        f"{', '.join(f'{e:.3e}' for e in nc['errs'])} (bound "
        f"{TRACE_BOUND:g}); collectives {nc['calls']} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(all(nc["identities"].values()) and max(nc["errs"]) < TRACE_BOUND,
          f"NCCL world size 1: {nc}")

    # the one-rank references: the headline and the small-order traces
    t0 = time.perf_counter()
    ref = p16_headline_run(None, dev, P16_HEAD_PLANES, f"{tmp}/ref.npy")
    ref_s = time.perf_counter() - t0
    zgrid = np.linspace(0.0, 3.0, 30001)
    zs = np.interp(np.array([1.0, 2.0]) * 250.0,
                   tmaps.comoving_distance_2f1(zgrid, 0.3), zgrid)
    with open(f"{tmp}/zs.txt", "w") as fp:
        fp.write("".join(f"{z:.10f}\n" for z in zs))
    write_catalog(f"{tmp}/gals", P16_TRACE_GALS, 16, 100.0, 990.0)
    t0 = time.perf_counter()
    one = p16_trace_cases(None, dev, tmp)
    say(f"phase 16 traces order 7/6, one rank: {time.perf_counter() - t0:.1f}"
        f" s")

    # the ranks: the headline (after a probe of gloo's primitives) on
    # P16_HEAD_RANKS, the traces on each of P16_TRACE_RANKS
    program = {P16_HEAD_RANKS: [(p16_headline_rank, (
        P16_HEAD_PLANES, f"{tmp}/mesh.npy"))]}
    for n in P16_TRACE_RANKS:
        program.setdefault(n, []).append((p16_trace_rank, (tmp,)))
    res = yield program
    heads = [r[0] for r in res[P16_HEAD_RANKS]]
    # gloo took every primitive on CUDA tensors (each rank probed them
    # before its headline, and a refused one failed the rank)
    probe = heads[0]["probe"]
    say(f"phase 16: gloo on CUDA tensors, {P16_HEAD_RANKS} ranks on one "
        f"card: " + "; ".join(f"{k} {v}" for k, v in probe.items()))
    check(all(v == "ok" for h in heads for v in h["probe"].values()),
          f"gloo on CUDA tensors: {[h['probe'] for h in heads]}")
    a = torch.from_numpy(np.load(f"{tmp}/mesh.npy"))
    b = torch.from_numpy(np.load(f"{tmp}/ref.npy"))
    errs = {q: float((a[r0:r1] - b[r0:r1]).abs().max()
                     / b[r0:r1].abs().max())
            for q, (r0, r1) in (("A", (6, 10)), ("alpha", (14, 16)))}
    del a, b
    counts_equal = bool(np.array_equal(heads[0]["counts"], ref["counts"]))
    peaks = [h["peak"] for h in heads]
    for h in heads:
        med = float(np.median([r["s"] for r in h["rows"][1:]]))
        say(f"phase 16 headline, rank {h['rank']} of {P16_HEAD_RANKS} "
            f"sharing one card ({card}), not a scaling result: m rows "
            f"{h['m_rows']}, setup {h['setup_s']:.2f} s; planes "
            + "; ".join(f"{r['plane']}: {r['s']:.4f} s, K1 {r['K1_ms']:.2f} "
                        f"ms, K2 {r['K2_ms']:.2f} ms, launches "
                        f"{r['launches']}" for r in h["rows"])
            + f"; timed median {med:.4f} s/plane; peak "
            f"{h['peak'] / 2**30:.2f} GiB ({h['resident'] / 2**30:.2f} "
            f"resident); collectives {h['calls']}; Profile'd plane "
            f"{h['profile'][0]:.4f} s: " + ", ".join(
                f"{k} {h['profile'][1][k]:.4f}" for k in PROFILE_TAGS)
            + f", collectives (synced) {h['profile'][2]:.4f} s")
        for r in h["rows"]:
            check(r["launches"] == {"legendre_analysis": 1,
                                    "legendre_synth": 1},
                  f"headline rank {h['rank']} plane {r['plane']}: launches "
                  f"{r['launches']}")
    rmed = float(np.median([r["s"] for r in ref["rows"][1:]]))
    say(f"phase 16 headline, one rank on the card: planes "
        + "; ".join(f"{r['plane']}: {r['s']:.4f} s, K1 {r['K1_ms']:.2f} ms, "
                    f"K2 {r['K2_ms']:.2f} ms" for r in ref["rows"])
        + f"; timed median {rmed:.4f} s/plane; peak "
        f"{ref['peak'] / 2**30:.2f} GiB ({ref_s:.1f} s)")
    say(f"phase 16 headline: {P16_HEAD_RANKS} ranks vs one rank after "
        f"planes {P16_HEAD_PLANES}: A {errs['A']:.3e}, alpha "
        f"{errs['alpha']:.3e} of each quantity's max (bounds "
        f"{P16_HEAD_BOUNDS}); order-{MAP_ORDER} lens map counts equal "
        f"{counts_equal}; peaks sum {sum(peaks) / 2**30:.2f} GiB (under "
        f"{DEVICE_MEMORY / 1e9:.0f} GB)")
    check(all(errs[q] < b for q, b in P16_HEAD_BOUNDS.items())
          and counts_equal
          and sum(peaks) < DEVICE_MEMORY,
          f"phase 16 headline: {errs}, counts equal {counts_equal}, peaks "
          f"{peaks}")

    # the small-order traces on 2 and 4 ranks against one rank on the card
    traces = {}
    for n in P16_TRACE_RANKS:
        res_n = traces[n] = [r[-1] for r in res[n]]
        errs = {k: grouped_row_err(torch.from_numpy(res_n[0]["cases"][k][0]),
                                   torch.from_numpy(v[0]))
                for k, v in one.items()}
        files = p16_compare_files(tmp, n)
        say(f"phase 16 traces order 7/6 f32, {n} ranks vs one rank on the "
            f"card, {P16_TRACE_PLANES} planes (run(): 4): " + ", ".join(
                f"{k} {e:.3e}" for k, e in errs.items())
            + f" (bound {TRACE_BOUND:g}); files: {files}; rank 0 launches "
            + "; ".join(f"{k} {v[1]}" for k, v in res_n[0]["cases"].items())
            + f"; collectives {res_n[0]['calls']}")
        check(max(errs.values()) < TRACE_BOUND and files["ok"],
              f"phase 16 traces on {n} ranks: {errs}, {files}")
        for r in res_n:
            c = r["cases"]
            check(all(x == {"legendre_analysis": 1, "legendre_synth": 1}
                       for x in c["NGP"][1])
                  and all(x == {"legendre_analysis": 8, "legendre_synth": 1}
                          for x in c["SPH"][1])
                  and all(x == {"legendre_analysis": 1, "legendre_synth": 4}
                          for x in c["4 blocks"][1])
                  and all(x.get("legendre_analysis_dot") == 1
                          and x.get("legendre_synth_vpu", 0) >= 1
                          and x.get("legendre_chain_seed", 0) >= 1
                          and "legendre_synth" not in x
                          for x in c["(k3, k4)"][1]),
                  f"phase 16 traces on {n} ranks: launches {c}")
    say(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return dict(probe=probe, heads=heads, ref=ref,
                traces={n: [r["cases"]["(k3, k4)"][1] for r in t]
                        for n, t in traces.items()})


def p16_compare_files(tmp, n):
    """run()'s files of n ranks against one rank's: ray files (layout and
    nest column equal, each other column within TRACE_BOUND of its max),
    lens maps (ray counts equal), galaxy catalogs (imaged sources equal
    but for GALS_SET_SLACK of them)."""
    import os

    from calclens_tpu_torch.gals import io as galsio
    from calclens_tpu_torch.io import fits

    a_dir, b_dir = f"{tmp}/1", f"{tmp}/{n}"
    names = sorted(os.listdir(a_dir))
    out = dict(ok=sorted(os.listdir(b_dir)) == names, rays=0.0, maps=0,
               gals=0)
    for name in names:
        if not os.path.exists(f"{b_dir}/{name}"):
            continue
        if name.startswith("rays_"):
            ha, hb = fits.read_fits(f"{a_dir}/{name}"), fits.read_fits(
                f"{b_dir}/{name}")
            ok = np.array_equal(ha[0][1], hb[0][1]) and np.array_equal(
                ha[1][1]["nest"], hb[1][1]["nest"])
            for col in ha[1][1].dtype.names:
                if col != "nest":
                    x = np.asarray(ha[1][1][col], np.float64)
                    y = np.asarray(hb[1][1][col], np.float64)
                    out["rays"] = max(out["rays"], float(
                        np.abs(x - y).max() / np.abs(x).max()))
            out["ok"] &= ok
        elif name.startswith("Rays_"):
            ok = np.array_equal(fits.read_fits(f"{a_dir}/{name}")[1][1][
                "N_RAYS"], fits.read_fits(f"{b_dir}/{name}")[1][1]["N_RAYS"])
            out["maps"] += 1
            out["ok"] &= ok
        elif name.startswith("gal_"):
            sa = set(galsio.read_image_gals(f"{a_dir}/{name}")["index"])
            sb = set(galsio.read_image_gals(f"{b_dir}/{name}")["index"])
            diff = len(sa ^ sb)
            out["gals"] += len(sa)
            out["ok"] &= diff <= GALS_SET_SLACK * max(len(sa), 1) + 1
    out["ok"] &= out["rays"] < TRACE_BOUND and out["maps"] == 2 and out[
        "gals"] > 0
    return out


# ----------------------------------------------------------------------------
# phase 17: the sharded multigrid step and the slab-decomposed THREEDPOT
# solve on ranks that share the card
# ----------------------------------------------------------------------------

# the full-width runs on ranks sharing the card over gloo: the MG design
# point (MG_ORDERS, MG_PARTICLES) with one untimed plane and one timed,
# Profile'd plane; THREEDPOT at TDP_NFFT and TDP_RAY_ORDER from
# TDP_PARTICLES in two files (one per rank) over P17_TDP_PLANES planes
P17_RANKS = 2
# phase 13's design point planes: its rays after them are the reference
P17_MG_PLANES = MG_DESIGN_PLANES
P17_TDP_PLANES = 2
# the small traces: ranks, and the MG cases at MG_TRACE_ORDERS (MG_TRACE_PLANES of
# P16_TRACE_PARTICLES at pixel centres); THREEDPOT at TDP_TRACE
P17_TRACE_RANKS = (2, 4)
P17_MG_CASES = {"default": {},
                "MGConvFact 0.1 + SPH": dict(MGConvFact=0.1,
                                             DepositScheme="SPH")}
# the slab solve rounds two float32 transforms (forward and inverse, both
# complex64, as the JAX slab solve) where the one-device solve rounds one
# (its inverse is complex128): its distance from the one-device potential
# is held to this many times phase 14's bound on the card's float32
# distance (TDP_F64_FACTOR times the distance at TDP_CPU_NFFT)
P17_SLAB_TRANSFORMS = 2
def p17_mg_run(mesh, device, ref_dir):
    """The MG design point on `mesh` (None: one device): plane
    P17_MG_PLANES[0] untimed, then P17_MG_PLANES[1] timed with Profile set
    (on a mesh with the collectives timed between syncs); its launches and
    V-cycles, the peak memory.  One device writes the A and alpha rows of
    its final rays, one file per rank's column block, into ref_dir; a rank
    reads its block and returns its distance from it."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.driver import Raytracer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = mg_config(MG_ORDERS)
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device=device, mesh=mesh)
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pos, mass = seeded_particles(MG_PARTICLES, 1.0, 12)
    staged = {p: rt.stage_particles(pos * (250.0 * p + 125.0), mass)
              for p in P17_MG_PLANES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, timed = P17_MG_PLANES
    t = time.perf_counter()
    rt.step(first, *staged[first])
    first_s = time.perf_counter() - t
    spent = {} if mesh is None else time_collectives(mesh)
    rt.cfg.Profile = True
    _ext.reset_launches()
    t = time.perf_counter()
    rt.step(timed, *staged[timed])  # ends in torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = {k: v for k, v in _ext.launches.items() if v}
    untime_collectives(mesh)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "phase 17 MG design point: non-finite rays")
    out = dict(rank=out_rank(mesh), setup_s=setup_s,
               first_s=first_s, step_s=step_s,
               row=dict(rt.phase_rows)[timed], launches=launches,
               cycles=dict(rt.mg_cycles), peak=peak, collectives=spent,
               patches=(rt.mgsetup.C if mesh is None
                        else mesh.block(rt.mgsetup.C)),
               columns=(int(rt.ray_bounds[out_rank(mesh)]),
                        int(rt.ray_bounds[out_rank(mesh) + 1])))
    if mesh is None:
        p17_save_mg_ref(rt.rays_packed, ref_dir)
    else:
        path = f"{ref_dir}/mg{mesh.rank}.npy"
        ref = torch.from_numpy(np.load(path)).to(rt.rays_packed.device)
        os.remove(path)
        got = torch.cat([rt.rays_packed[a0:b0]
                         for a0, b0 in P17_MG_ROWS.values()])
        k = 0
        out["dist"] = {}
        for q, (a0, b0) in P17_MG_ROWS.items():
            d = b0 - a0
            out["dist"][q] = (float((got[k:k + d] - ref[k:k + d]).abs().max()),
                              float(ref[k:k + d].abs().max()))
            k += d
        del ref, got
    del rt, staged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def out_rank(mesh):
    return 0 if mesh is None else mesh.rank


# the packed rows of the MG ranks' comparison with one rank, and their
# bounds relative to each quantity's max: the readings of the two ranks
# (the same on every run: both sides sum in a fixed order) were A
# 1.513e-03 and 9.864e-04, alpha 5.087e-05 and 5.022e-05 on an H100, 700 W,
# where K1's atomic adds allowed 1e-2; about 2.6x and 3x the larger
P17_MG_ROWS = {"A": (6, 10), "alpha": (14, 16)}
P17_MG_BOUNDS = {"A": 4e-3, "alpha": 1.5e-4}


def p17_save_mg_ref(packed, ref_dir):
    """The A and alpha rows of one device's rays, one file per rank's
    column block (<ref_dir>/mg<rank>.npy): phase 17's MG reference."""
    import torch

    for r in range(P17_RANKS):
        a, b = block_of(packed.shape[1], r)
        np.save(f"{ref_dir}/mg{r}.npy", torch.cat(
            [packed[a0:b0, a:b] for a0, b0 in P17_MG_ROWS.values()]
        ).cpu().numpy())


def p17_save_tdp_ref(rt, ref_dir):
    """One device's THREEDPOT grid and rays (<ref_dir>/grid.npy,
    rays.npy): phase 17's THREEDPOT reference."""
    np.save(f"{ref_dir}/grid.npy", rt.threedpot._cached[2].cpu().numpy())
    np.save(f"{ref_dir}/rays.npy", rt.rays_packed.cpu().numpy())


def block_of(total, rank):
    """Rank `rank`'s block of an axis of `total` on P17_RANKS ranks (the
    Mesh's block_bounds)."""
    from calclens_tpu_torch.parallel.sharding import block_bounds

    b = block_bounds(total, P17_RANKS)
    return int(b[rank]), int(b[rank + 1])


def p17_tdp_run(mesh, device, tmp):
    """THREEDPOT at full width on `mesh` (None: one device) from the
    snapshot <tmp>/snap_full (two files): P17_TDP_PLANES planes through
    Raytracer.step, plane 0 (with the grid build) by parts with CUDA
    events (on a mesh with the collectives timed between syncs), the peak.
    One device writes its grid and final rays into tmp; a rank returns
    its x rows' distance from that grid and its columns' distance from
    those rays, and the particles it deposited."""
    import torch

    from calclens_tpu_torch.driver import Raytracer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = threedpot_config(f"{tmp}/full.txt", TDP_RAY_ORDER, TDP_NFFT,
                           TDP_MAX_DIST, TDP_PLANES)
    rt = Raytracer(cfg, device=device, mesh=mesh)
    rt.init_rays()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spent = {} if mesh is None else time_collectives(mesh)
    parts = {}
    rt._timed_phase = lambda plane_num: event_phase(parts)
    rt.cfg.Profile = True  # the step passes the hook only in Profile mode
    times = []
    for p in range(P17_TDP_PLANES):
        if p == 1:
            rt.cfg.Profile = False
        t = time.perf_counter()
        rt.step(p)  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    untime_collectives(mesh)
    peak = torch.cuda.max_memory_allocated()
    d = rt.threedpot
    check(d.builds == 1, f"phase 17 THREEDPOT grid built {d.builds} times")
    check(bool(torch.isfinite(rt.rays_packed).all()),
          "phase 17 THREEDPOT: non-finite rays")
    grid = d._cached[2]
    out = dict(rank=out_rank(mesh), times=times, peak=peak,
               part_ms={tag: sum(a.elapsed_time(b) for a, b in v)
                        for tag, v in parts.items()},
               collectives=dict(spent), rows=d.rows_deposited,
               files=[f for f, _ in d._my_files(d.snaps[0]["fname"])])
    if mesh is None:
        p17_save_tdp_ref(rt, tmp)
    else:
        a, b = mesh.block(TDP_NFFT)
        ref = np.load(f"{tmp}/grid.npy", mmap_mode="r")
        ref = torch.from_numpy(np.ascontiguousarray(ref[a:b])).to(
            grid.device)
        out["slab_dist"] = max_rel(grid[a:b], ref)
        del ref
        c0, c1 = (int(rt.ray_bounds[mesh.rank]),
                  int(rt.ray_bounds[mesh.rank + 1]))
        ref = torch.from_numpy(np.load(f"{tmp}/rays.npy")).to(grid.device)
        out["ray_err"] = [
            (float((rt.rays_packed[a0:b0] - ref[a0:b0, c0:c1]).abs().max()),
             float(ref[a0:b0].abs().max()))
            for a0, b0 in ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16),
                           (16, 20), (20, 21))]
        del ref
    del rt, grid, d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p17_full_rank(mesh, ref_dir):
    """The two full-width runs on this rank of the shared card, against
    the one-rank references in ref_dir."""
    return dict(mg=p17_mg_run(mesh, mesh.device, ref_dir),
                tdp=p17_tdp_run(mesh, mesh.device, ref_dir))


def p17_trace_cases(mesh, device, tmp):
    """The small traces on `mesh` (None: one device): the MG cases at
    MG_TRACE_ORDERS over MG_TRACE_PLANES (each plane's launches and V-cycles),
    and the THREEDPOT trace (TDP_TRACE's snapshots in tmp; each grid
    built once); the whole rays after each case (host numpy)."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.driver import Raytracer

    out = {}
    for label, kw in P17_MG_CASES.items():
        cfg = mg_config(MG_TRACE_ORDERS, **kw)
        rt = Raytracer(cfg, device=device, mesh=mesh)
        rt.init_rays()
        counts = []
        for p in range(MG_TRACE_PLANES):
            pos, mass = pixel_centre_particles(cfg, rt.cosmo, p,
                                               P16_TRACE_PARTICLES, 100 + p)
            _ext.reset_launches()
            rt.step(p, pos=pos, mass=mass)
            counts.append({k: v for k, v in _ext.launches.items() if v})
        out[label] = (rt.packed_global().cpu().numpy(), counts,
                      dict(rt.mg_cycles))
        del rt
    T = TDP_TRACE
    cfg = threedpot_config(f"{tmp}/trace.txt", T["ray_order"], T["nfft"],
                           T["max_dist"], T["planes"])
    rt = Raytracer(cfg, device=device, mesh=mesh)
    rt.init_rays()
    for p in range(T["planes"]):
        rt.step(p)
    out["threedpot"] = (rt.packed_global().cpu().numpy(), rt.threedpot.builds)
    torch.cuda.synchronize()
    return out


def p17_trace_rank(mesh, tmp):
    res = p17_trace_cases(mesh, mesh.device, tmp)
    return dict(cases={k: ((v[0] if mesh.rank == 0 else None),) + v[1:]
                       for k, v in res.items()}, calls=dict(mesh.calls))


def p17_nccl(mesh, tmp, one):
    """NCCL at world size 1: the small traces sharded on it against the
    one-device traces `one` on the same card (grouped_row_err)."""
    import torch

    check(mesh.backend == "nccl" and mesh.size == 1, f"{mesh}")
    res = p17_trace_cases(mesh, mesh.device, tmp)
    errs = {k: grouped_row_err(torch.from_numpy(v[0]),
                               torch.from_numpy(one[k][0]))
            for k, v in res.items()}
    return dict(errs=errs, calls=dict(mesh.calls))


def p17_write_full_snapshot(tmp):
    """Phase 14's full-width snapshot (TDP_PARTICLES in two files, its
    seed) and its list, as threedpot_full writes them."""
    pos = clumpy_snapshot(TDP_PARTICLES, TDP_BOX, 14)
    write_lgadget(f"{tmp}/snap_full", pos, TDP_BOX, 1.0, 2)
    del pos
    with open(f"{tmp}/full.txt", "w") as fp:
        fp.write(f"{tmp}/snap_full\n")


def p17_write_trace_snapshots(tmp):
    """TDP_TRACE's two snapshots (the second in two files) and their
    list."""
    from calclens_tpu_torch.cosmology import Cosmology

    T = TDP_TRACE
    cosmo = Cosmology(0.3)
    stems = []
    for k, chi in enumerate(T["snap_chi"]):
        stem = f"{tmp}/snap_{k}"
        write_lgadget(stem, clumpy_snapshot(T["particles"], T["box"], 20 + k,
                                            T["clumps"]),
                      T["box"], float(cosmo.acomvdist(chi)), k + 1)
        stems.append(stem)
    with open(f"{tmp}/trace.txt", "w") as fp:
        fp.write("\n".join(stems) + "\n")


def p17_coarse_distance(tmp, dev):
    """Phase 14's float32 distance on the card at TDP_CPU_NFFT: the
    snapshot's counts solved in float32 (potential_from_counts) against
    float64 (solve_potential)."""
    import torch
    from calclens_tpu_torch import fftpot
    from calclens_tpu_torch.cosmology import RHO_CRIT
    from calclens_tpu_torch.io import lgadget

    coarse = torch.zeros((TDP_CPU_NFFT,) * 3, dtype=torch.float32,
                         device=dev)
    for fn in fftpot.snapshot_files(f"{tmp}/snap_full"):
        pos, _ = lgadget.read_positions_f32(fn)
        fftpot.cic_deposit_3d(torch.from_numpy(pos).to(dev), TDP_CPU_NFFT,
                              np.float32(TDP_BOX), coarse)
    mp = RHO_CRIT * 0.3 * TDP_BOX ** 3 / TDP_PARTICLES
    p32 = fftpot.potential_from_counts(coarse, TDP_CPU_NFFT, TDP_BOX, 1.0, mp)
    p64 = fftpot.solve_potential(coarse.double(), TDP_CPU_NFFT, TDP_BOX, 1.0,
                                 mp, torch.float64)
    return max_rel(p32, p64)


def p17_report_collectives(spent):
    return ", ".join(f"{k} {v[0]:.4f} s / {v[1] / 1e9:.4f} GB sent "
                     f"({v[2]} calls)" for k, v in sorted(spent.items()))


def sharded_phase(dev, card, tmp, refs=None):
    """Phase 17 (see the module docstring); prints and checks; returns the
    MG ranks' results for the kernels line.  refs: (the directory where
    phases 13 and 14 left the one-rank references and the snapshot, phase
    14's float32 distance at TDP_CPU_NFFT); None makes them here, in tmp.
    A generator for run_phases: it yields the parts its ranks run and
    takes their results."""
    import shutil

    import torch
    import torch.distributed as dist
    from calclens_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.perf_counter()
    rank_dev = f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    p17_write_trace_snapshots(tmp)
    if refs is None:
        # one device: the references of the full-width runs
        p17_write_full_snapshot(tmp)
        mg_one = p17_mg_run(None, dev, tmp)
        tdp_one = p17_tdp_run(None, dev, tmp)
        refs = (tmp, p17_coarse_distance(tmp, dev))
        torch.cuda.empty_cache()
        say(f"phase 17: one rank on the card: MG design point plane "
            f"{P17_MG_PLANES[1]} {mg_one['step_s']:.4f} s (first "
            f"{mg_one['first_s']:.4f} s), peak {mg_one['peak'] / 2**30:.2f} "
            f"GiB; THREEDPOT planes "
            + ", ".join(f"{t:.4f}" for t in tdp_one["times"])
            + f" s, peak {tdp_one['peak'] / 2**30:.2f} GiB")
    ref_dir, d128 = refs
    say(f"phase 17: snapshots and one-rank references ready "
        f"({time.perf_counter() - t0:.1f} s; {ref_dir}: "
        f"{shutil.disk_usage(ref_dir).free / 1e9:.1f} GB free); ranks share "
        f"card 0 over gloo ({card}), not a scaling result; float32 "
        f"potential vs float64 at NFFT {TDP_CPU_NFFT}: {d128:.3e}")

    # the full-width runs on ranks sharing the card
    t0 = time.perf_counter()
    t0 = time.perf_counter()
    one = p17_trace_cases(None, dev, tmp)
    say(f"phase 17 traces, one rank: V-cycles " + ", ".join(
        f"{k} {v[2]}" for k, v in one.items() if k in P17_MG_CASES)
        + f" ({time.perf_counter() - t0:.1f} s)")
    # the ranks: the full-width runs on P17_RANKS, the traces on each of
    # P17_TRACE_RANKS
    program = {P17_RANKS: [(p17_full_rank, (ref_dir,))]}
    for n in P17_TRACE_RANKS:
        program.setdefault(n, []).append((p17_trace_rank, (tmp,)))
    res = yield program
    full = [r[0] for r in res[P17_RANKS]]
    mg_peaks = [r["mg"]["peak"] for r in full]
    for r in full:
        m = r["mg"]
        dist_ = {q: a / b for q, (a, b) in m["dist"].items()}
        say(f"phase 17 MG design point, rank {m['rank']} of {P17_RANKS} "
            f"({card}): patches {m['patches']}, columns {m['columns']}, "
            f"setup {m['setup_s']:.2f} s, plane {P17_MG_PLANES[0]} "
            f"{m['first_s']:.4f} s, plane {P17_MG_PLANES[1]} (Profile'd) "
            f"{m['step_s']:.4f} s: " + ", ".join(
                f"{k} {v:.4f}" for k, v in m["row"].items())
            + f"; collectives (synced) {p17_report_collectives(m['collectives'])}"
            f"; launches {m['launches']}; V-cycles {m['cycles']}; peak "
            f"{m['peak'] / 2**30:.2f} GiB; vs one rank: A {dist_['A']:.3e}, "
            f"alpha {dist_['alpha']:.3e} of max (bounds "
            f"{P17_MG_BOUNDS})")
        check(all(dist_[q] < b for q, b in P17_MG_BOUNDS.items()),
              f"phase 17 MG rank {m['rank']} vs one rank: {dist_}")
        check(m["launches"] == PLANE_LAUNCHES["MG"],
              f"phase 17 MG rank {m['rank']} launches {m['launches']}")
        check(set(m["cycles"].values()) == {10},
              f"phase 17 MG rank {m['rank']} V-cycles {m['cycles']}")
        check(all(m["collectives"].get(k, [0, 0, 0])[2] > 0 for k in (
            "reduce_scatter_blocks", "reduce_scatter_rows", "all_gather_cols",
            "all_gather_rows", "exchange")),
              f"phase 17 MG rank {m['rank']} collectives {m['collectives']}")
    say(f"phase 17 MG design point: peaks sum {sum(mg_peaks) / 2**30:.2f} "
        f"GiB (under {DEVICE_MEMORY / 1e9:.0f} GB)")
    check(sum(mg_peaks) < DEVICE_MEMORY, f"phase 17 MG peaks {mg_peaks}")
    slab_bound = P17_SLAB_TRANSFORMS * TDP_F64_FACTOR * d128
    tdp_peaks = [r["tdp"]["peak"] for r in full]
    for r in full:
        t = r["tdp"]
        pm = t["part_ms"]
        rel = max(a / b for a, b in t["ray_err"])
        say(f"phase 17 THREEDPOT NFFT {TDP_NFFT}, rayOrder {TDP_RAY_ORDER}, "
            f"rank {t['rank']} of {P17_RANKS} ({card}): files "
            f"{[os.path.basename(f) for f in t['files']]}, {t['rows']} "
            f"particles; planes " + ", ".join(f"{x:.4f}" for x in t["times"])
            + " s; plane 0 by parts (CUDA events): " + ", ".join(
                f"{k} {pm[k]:.2f} ms" for k in TDP_PARTS if k in pm)
            + f"; collectives (synced) "
            f"{p17_report_collectives(t['collectives'])}; peak "
            f"{t['peak'] / 2**30:.2f} GiB; its x rows vs the one-device "
            f"potential {t['slab_dist']:.3e} (bound {P17_SLAB_TRANSFORMS} x "
            f"{TDP_F64_FACTOR:g} x {d128:.3e} = {slab_bound:.3e}); its rays "
            f"vs one rank {rel:.3e} (bound {TRACE_BOUND:g})")
        check(t["slab_dist"] <= slab_bound and rel < TRACE_BOUND,
              f"phase 17 THREEDPOT rank {t['rank']}: slab {t['slab_dist']}, "
              f"rays {t['ray_err']}")
        check(all(t["collectives"].get(k, [0, 0, 0])[2] > 0 for k in (
            "reduce_scatter_rows", "exchange", "all_gather_rows")),
              f"phase 17 THREEDPOT rank {t['rank']} collectives "
              f"{t['collectives']}")
    check(sum(r["tdp"]["rows"] for r in full) == TDP_PARTICLES
          and sum(tdp_peaks) < DEVICE_MEMORY,
          f"phase 17 THREEDPOT particles {[r['tdp']['rows'] for r in full]}"
          f", peaks {tdp_peaks}")
    say(f"phase 17 THREEDPOT: the ranks deposited "
        f"{sum(r['tdp']['rows'] for r in full)} of {TDP_PARTICLES} particles;"
        f" peaks sum {sum(tdp_peaks) / 2**30:.2f} GiB")

    # the small traces on 2 and 4 ranks against one rank on the card
    for n in P17_TRACE_RANKS:
        res_n = [r[-1] for r in res[n]]
        errs = {k: grouped_row_err(
            torch.from_numpy(res_n[0]["cases"][k][0]),
            torch.from_numpy(v[0])) for k, v in one.items()}
        say(f"phase 17 traces f32, {n} ranks vs one rank on the card: MG "
            f"order {MG_TRACE_ORDERS} {MG_TRACE_PLANES} planes, THREEDPOT "
            f"NFFT {TDP_TRACE['nfft']} rayOrder {TDP_TRACE['ray_order']} "
            f"{TDP_TRACE['planes']} planes: " + ", ".join(
                f"{k} {e:.3e}" for k, e in errs.items())
            + f" (bound {TRACE_BOUND:g}); rank 0 launches "
            + "; ".join(f"{k} {res_n[0]['cases'][k][1]}"
                        for k in P17_MG_CASES)
            + f"; collectives {res_n[0]['calls']}")
        check(max(errs.values()) < TRACE_BOUND,
              f"phase 17 traces on {n} ranks: {errs}")
        for r in res_n:
            c = r["cases"]
            for k in P17_MG_CASES:
                check_plane_launches(f"phase 17 MG trace {k}, {n} ranks",
                                     c[k][1], "MG")
                check(c[k][2] == one[k][2],
                      f"phase 17 MG trace {k} on {n} ranks: V-cycles "
                      f"{c[k][2]}, one rank {one[k][2]}")
            check(c["threedpot"][1] == 2,
                  f"phase 17 THREEDPOT trace builds {c['threedpot'][1]}")

    # NCCL at world size 1, in this process
    t0 = time.perf_counter()
    try:
        nc = p17_nccl(make_mesh("nccl", f"file://{tmp}/nccl17", 0, 1,
                                device=rank_dev), tmp, one)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"phase 17: NCCL world size 1, the traces vs one device: "
        + ", ".join(f"{k} {e:.3e}" for k, e in nc["errs"].items())
        + f" (bound {TRACE_BOUND:g}); collectives {nc['calls']} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(max(nc["errs"].values()) < TRACE_BOUND,
          f"phase 17 NCCL world size 1: {nc}")
    say(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return dict(mg=[r["mg"] for r in full])


def run_program(mesh, program):
    """One rank's parts in order: [fn(mesh, *args) for fn, args in
    program], each part counting its own collectives (mesh.calls)."""
    out = []
    for fn, args in program:
        mesh.calls.clear()
        out.append(fn(mesh, *args))
    return out


def run_phases(phases, dev, tmp):
    """Run the mesh phases (generators: each yields {ranks: [(fn, args),
    ...]} and takes {ranks: [each rank's results of its parts]}) with one
    spawn per rank count shared by all of them (parallel/launch.run_ranks,
    ranks on the card over gloo): a spawn's ranks take ~10 s to reach the
    card.  Returns each phase's value."""
    from calclens_tpu_torch.parallel.launch import run_ranks

    programs = [next(p) for p in phases]
    results = [{} for _ in phases]
    for n in sorted({n for prog in programs for n in prog}):
        parts = [step for prog in programs for step in prog.get(n, [])]
        t0 = time.perf_counter()
        res = run_ranks(run_program, n, f"{tmp}/ranks{n}",
                        device=f"cuda:{dev.index or 0}", timeout=P16_TIMEOUT,
                        threads=0, args=(parts,))
        say(f"{n} ranks sharing the card ran {len(parts)} parts in "
            f"{time.perf_counter() - t0:.1f} s")
        k = 0
        for prog, out in zip(programs, results):
            m = len(prog.get(n, []))
            out[n] = [r[k:k + m] for r in res]
            k += m
    values = []
    for p, out in zip(phases, results):
        try:
            p.send(out)
        except StopIteration as stop:
            values.append(stop.value)
        else:
            raise SmokeFailure("a mesh phase yielded twice")
    return values


def report_before(card, kernel_ms, steps):
    """This run's K1 and K4 ms per order and each step configuration's
    s/plane (median of its timed planes) and peak beside BEFORE_KERNEL_MS
    and BEFORE_STEPS, each line with the card's name and power limit."""
    for name in ("legendre_analysis", "legendre_analysis_dot"):
        say(f"{card}: {name} ms at orders 10 / 12 / 13: " + " / ".join(
            f"{kernel_ms[(name, o)]:.2f} "
            + (f"(before {BEFORE_KERNEL_MS[(name, o)]})"
               if (name, o) in BEFORE_KERNEL_MS else "(not run before)")
            for o in (10, 12, 13)))
    for label, (times, peak) in steps.items():
        was_s, was_gib = BEFORE_STEPS[label]
        say(f"{card}: {label} {float(np.median(times)):.4f} s/plane (before "
            f"{was_s}), peak {peak / 2**30:.2f} GiB (before {was_gib})")


def main():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    import calclens_tpu_torch  # noqa: F401  (fails outside the checkout)
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.sht.plan import DEFAULT_SYNTHESIS_RINGS_MODE
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht import transforms as T

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _ext.lib()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_ext.build_seconds if _ext.build_seconds is not None else 'cached'})")
    for src, log in _ext.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                say(f"  {src}: {line.strip()}")

    if sys.argv[1:] == ["--phase", "15"]:
        stream_phase(dev, card)
        say(f"chip_smoke --phase 15: {time.perf_counter() - t_start:.1f} s")
        return
    for n, phase in (("16", mesh_phase), ("17", sharded_phase)):
        if sys.argv[1:] == ["--phase", n]:
            with tempfile.TemporaryDirectory() as tmp:
                run_phases([phase(dev, card, tmp)], dev, tmp)
            say(f"chip_smoke --phase {n}: "
                f"{time.perf_counter() - t_start:.1f} s")
            return

    t_phase = time.perf_counter()
    # 3. kernels vs twins at orders 8 and 10; times at order 10
    variants10 = None
    for order, reps in ((8, 1), (10, 3)):
        plan, _, streams, ana = band_limited_inputs(order, dev, order)
        k1, k2 = compare_kernels(plan, streams, ana, reps)
        for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                               ("K2 legendre_synth", k2, K2_BOUND)):
            say(f"order {order} {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
                f"(bound {bound:g}); kernel {k[2]:.3f} ms, twin "
                f"{k[3]:.1f} ms")
            check(k[0] < bound, f"{name} off its twin at order {order}: "
                  f"{k[0]:.3e}")
        variants = compare_variants(plan, streams, ana, reps)
        for name, k in variants.items():
            say(f"order {order} {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
                f"(bound {VARIANT_BOUND:g}); kernel {k[2]:.3f} ms, twin "
                f"{k[3]:.1f} ms")
            check(k[0] < VARIANT_BOUND, f"{name} off its twin at order "
                  f"{order}: {k[0]:.3e}")
        variants10, k1_10 = variants, k1
        check_seed_table(plan)
        del plan, streams, ana
        torch.cuda.empty_cache()

    say(f"phase 3: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 4. CUDA vs CPU trace, default and variant kernels with the default
    # synthesis ring stage, then the default kernels with "uniform"
    runs = [(*k, DEFAULT_SYNTHESIS_RINGS_MODE) for k in PATH_KERNELS]
    if DEFAULT_SYNTHESIS_RINGS_MODE != "uniform":
        runs.append(("k2", "k1", "uniform"))
    for synth, analysis, rings_mode in runs:
        errs, counts = trace_cuda_vs_cpu(synth, analysis, rings_mode)
        say(f"trace order 7/6 f32 ({synth}, {analysis}, {rings_mode}), CUDA "
            f"vs CPU per plane: {', '.join(f'{e:.3e}' for e in errs)} "
            f"(bound {TRACE_BOUND:g}); launches {counts}")
        check(max(errs) < TRACE_BOUND, f"CUDA trace ({synth}, {analysis}, "
              f"{rings_mode}) off the CPU trace: {errs}")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_err, run_counts = run_with_maps()
    say(f"Raytracer.run order 7/6 f32, 8 planes, lens maps at LensMapOrder 4 "
        f"after planes 1 and 2: card vs CPU files {run_err:.3e} (bound "
        f"{TRACE_BOUND:g}), ray counts exact; card launches {run_counts} "
        f"({time.perf_counter() - t0:.1f} s for both runs)")
    torch.cuda.empty_cache()

    say(f"phase 4: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 5. headline shape through Raytracer.step, default then variant
    h = headline("k2", "k1", (2, 3), snapshot_after=3,
                 maps_order=MAP_ORDER, profile_plane=5,
                 compare_mode=("uniform" if DEFAULT_SYNTHESIS_RINGS_MODE
                               != "uniform" else None), repeat=True)
    report_headline("headline", h)
    map_err, map_s, map_npix = h["maps"]
    say(f"lens maps of the headline rays at LensMapOrder {MAP_ORDER} "
        f"({map_npix} pixels): card vs float64 host sums {map_err:.3e} of "
        f"each row's max (bound {MAP_BOUND:g}), counts exact; driver's map "
        f"writer {map_s:.3f} s; Convergence_ and Rays_ FITS read back")
    torch.cuda.empty_cache()
    hv = headline("k3", "k4", (2, 3), snapshot_after=3, repeat=True)
    report_headline("variant headline (k3, k4)", hv)
    dist = grouped_row_err(hv["snap"], h["snap"])
    say(f"variant headline rays vs default after planes 1-3: {dist:.3e} of "
        f"each quantity's max")
    check(math.isfinite(dist), "variant headline: distance not finite")
    del hv["snap"]  # h["snap"] starts phase 10's mass-map plane
    torch.cuda.empty_cache()

    say(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 6. the kernels at the headline shape
    plan, alm, streams, ana = band_limited_inputs(12, dev, 12)
    k1, k2 = compare_kernels(plan, streams, ana, reps=3)
    for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                           ("K2 legendre_synth", k2, K2_BOUND)):
        say(f"order 12 {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
            f"(bound {bound:g}); kernel {k[2]:.2f} ms, twin {k[3]:.0f} ms")
        check(k[0] < bound, f"{name} off its twin at order 12: {k[0]:.3e}")
    rows12 = check_variant_rows(plan, streams, ana, reps=2)
    for name, k in rows12.items():
        say(f"order 12 {name}: rows {CHECK_ROWS} rel {k[0]:.3e} abs "
            f"{k[1]:.3e} (bound {VARIANT_BOUND:g}); kernel {k[2]:.2f} ms")
        check(k[0] < VARIANT_BOUND, f"{name} off its twin on rows at "
              f"order 12: {k[0]:.3e}")
    seed12 = check_seed_table(plan)
    # K4 against K1: the same lambda bits, sums in another order
    k4vk1 = pair_errs(TL.analysis_dot_cuda(*ana, plan.nl),
                      TL.analysis_cuda(*ana, plan.nl))
    say(f"order 12 K4 vs K1: rel {k4vk1[0]:.3e} abs {k4vk1[1]:.3e} "
        f"(bound {VARIANT_BOUND:g})")
    check(k4vk1[0] < VARIANT_BOUND, f"K4 off K1 at order 12: {k4vk1[0]:.3e}")
    # run to run: every kernel twice on the same inputs; K1 and K4 (whose
    # 512-ring tiles add up in a fixed order) on a block of m rows
    rows_bits, m_block = block_rows(plan, None, ana)
    report_bits("order 12 kernels", kernels_twice(plan, streams, ana),
                rows_bits, m_block)
    # alm2map (K2, 4 columns) against the potential of alm2allmaps (K2, 16)
    ref_phi = T.alm2allmaps(plan, alm)[0]
    _ext.reset_launches()
    phi = T.alm2map(plan, alm)
    torch.cuda.synchronize()
    phi_launches = _ext.launches["legendre_synth_phi"]
    check(phi_launches == 1, f"alm2map launched {dict(_ext.launches)}")
    phi_err = rel_err(phi, ref_phi)
    say(f"order 12 alm2map (K2-4col) vs alm2allmaps[0] (K2-16): rel "
        f"{phi_err:.3e} (bound {VARIANT_BOUND:g}); launches "
        f"{phi_launches}")
    check(phi_err < VARIANT_BOUND, f"alm2map off alm2allmaps: {phi_err:.3e}")
    # the same with K3: its potential-only form against its 12 buckets
    plan.synth_kernel = "k3"
    ref_phi = T.alm2allmaps(plan, alm)[0]
    _ext.reset_launches()
    phi = T.alm2map(plan, alm)
    torch.cuda.synchronize()
    phi3_launches = _ext.launches["legendre_synth_vpu_phi"]
    check(phi3_launches == 1 and _ext.launches["legendre_chain_seed"] == 1,
          f"alm2map with K3 launched {dict(_ext.launches)}")
    phi3_err = rel_err(phi, ref_phi)
    plan.synth_kernel = "k2"
    say(f"order 12 alm2map (K3 potential-only) vs alm2allmaps[0] (K3): rel "
        f"{phi3_err:.3e} (bound {VARIANT_BOUND:g}); launches {phi3_launches}")
    check(phi3_err < VARIANT_BOUND,
          f"alm2map with K3 off alm2allmaps: {phi3_err:.3e}")
    del phi, ref_phi
    # K3 against K2 on the same alm: printed, not bounded
    q2 = T.legendre_synthesis(plan, alm, True)
    plan.synth_kernel = "k3"
    q3 = T.legendre_synthesis(plan, alm, True)
    plan.synth_kernel = "k2"
    k3vk2 = [max(rel_err(q3[h_][k], q2[h_][k]) for h_ in (0, 1))
             for k in range(3)]
    say(f"order 12 K3 vs K2 (qN, qS) distance, phi / d_theta / "
        f"d_theta_theta: {', '.join(f'{e:.3e}' for e in k3vk2)} of max|K2|")
    t0 = time.perf_counter()
    twins64, to64 = distance_from_f64(plan, alm, q2, q3)
    say(f"order 12 float64 twins of K2 and K3 on rows {CHECK_ROWS}: "
        f"{twins64:.3e} apart ({time.perf_counter() - t0:.1f} s)")
    for name, (per_q, per_row) in to64.items():
        say(f"order 12 {name} vs float64 on rows {CHECK_ROWS}, phi / "
            f"d_theta / d_theta_theta, polar caps | belt: "
            f"{', '.join(f'{c:.3e} | {b:.3e}' for c, b in per_q)}; "
            f"d_theta per row: {', '.join(f'{e:.2e}' for e in per_row)}")
    check(twins64 < 1e-9 and all(
        math.isfinite(x) for per_q, per_row in to64.values()
        for x in (*sum(per_q, ()), *per_row)),
        f"float64 references: twins {twins64:.3e} apart or non-finite")
    del q2, q3
    torch.cuda.empty_cache()

    bounds = kernel_bounds(plan)
    for name, b in bounds.items():
        floor = ("" if b["floor_ms"] is None else
                 f"; issue floor {b['floor_ms']:.3f} ms "
                 f"({SLOTS_PER_ELEMENT[name]} slots per element)")
        say(f"order 12 bound {name}: {b['bound_ms']:.3f} ms ({b['bound_by']}) "
            f"on {b['elems']:.4e} elements; {b['full_bound_ms']:.3f} ms on "
            f"the full triangle{floor}")
    v10 = {k.split()[1]: v for k, v in variants10.items()}
    v12 = {k.split()[1]: v for k, v in rows12.items()}

    say(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 7. P1, the Legendre roofline probe; the kernels' shares of its
    # ceilings from the order-12 times above (not timed again)
    kernel_ms = {"legendre_analysis": k1[2], "legendre_synth": k2[2],
                 **{k: v[2] for k, v in v12.items()}}
    del alm, streams, ana
    torch.cuda.empty_cache()
    p1 = probe_phase(dev, kernel_ms, plan)
    del plan  # its ring tables (~6.5 GiB) must not count in phase 10's peaks
    torch.cuda.empty_cache()

    say(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 8. P2-P4, the gather probes, beside torch's tab[idx]
    gathers = gather_phase(dev)
    torch.cuda.empty_cache()

    say(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 9. the synthesis ring stages on K2's streams; the port's default mode
    # must be the fastest one here (within RING_DEFAULT_SLACK)
    rings = ring_stage_phase(dev)
    report_ring_stages(rings, DEFAULT_SYNTHESIS_RINGS_MODE)
    torch.cuda.empty_cache()

    say(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 10. the deposit schemes and sky cuts at the headline shape: SPH (K1
    # eight times per plane), CIC in the octant box with its lens maps, and
    # one precomputed mass-map plane against the particle path
    hs = headline("k2", "k1", (2,), snapshot_after=None, profile_plane=4,
                  repeat=True, DepositScheme="SPH")
    report_headline_path("SPH headline", hs, "SPH")
    torch.cuda.empty_cache()
    scipy_s, port_s = legendre_route_seconds(1023)
    say(f"one kernel_bl window at lmax 1023: scipy eval_legendre route "
        f"{scipy_s:.3f} s, the port's recurrence {port_s:.4f} s (equal "
        f"values)")
    hc = headline("k2", "k1", (2,), snapshot_after=None,
                  maps_order=MAP_ORDER, profile_plane=4, repeat=True,
                  DepositScheme="CIC", **OCTANT)
    report_headline_path("cut-sky CIC headline (octant)", hc, "CIC")
    map_err, map_s, map_npix = hc["maps"]
    say(f"lens maps of the octant's rays at LensMapOrder {MAP_ORDER} "
        f"({map_npix} pixels): card vs float64 host sums {map_err:.3e} of "
        f"each row's max (bound {MAP_BOUND:g}), counts exact; driver's map "
        f"writer {map_s:.3f} s")
    torch.cuda.empty_cache()
    snap = h.pop("snap")  # the headline rays after plane 3
    mm = mass_map_plane(snap, 4)
    say(f"mass-map plane 4 at order 12 from the headline rays: density "
        f"equal to the particle deposit's bit for bit; rays vs the particle "
        f"plane (beside the particle plane run twice), of each quantity's "
        f"max: " + ", ".join(f"{q} {a:.3e} ({b:.3e})"
                             for q, (a, b) in mm[0].items())
        + f"; all equal bit for bit; step {mm[1]:.4f} s; "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(mm[2].items()))
        + f"; launches {({k: v for k, v in mm[3].items() if v})}; count map "
        f"written in {mm[4]:.2f} s")
    torch.cuda.empty_cache()

    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 11. CUDA vs CPU traces of the new paths at SHTOrder 7 / rayOrder 6
    for label, kw, maps in (("SPH", dict(DepositScheme="SPH"), False),
                            ("CIC 40x40 box", dict(DepositScheme="CIC",
                                                   **TRACE_BOX), False),
                            ("mass maps", {}, True)):
        errs, nrays, vac_diff = trace_path(label, kw, maps)
        say(f"trace order 7/6 f32 {label}, CUDA vs CPU per plane: "
            f"{', '.join(f'{e:.3e}' for e in errs)} (bound {TRACE_BOUND:g}); "
            f"{nrays} rays on both; vacuum-mask pixels differing {vac_diff}")
    torch.cuda.empty_cache()

    say(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # 12. the galaxy image search and the CMB mode
    t0 = time.perf_counter()
    gals = gals_cmb_phase()
    report_gals_cmb(gals, card)
    say(f"phase 12: {time.perf_counter() - t0:.1f} s")
    gals_launches = gals["run"]["launches"]
    torch.cuda.empty_cache()

    # 13. the multigrid step at its design point, the small MG traces, and
    # the ray outputs (the headline rays' files; run() with every output)
    # phases 13 and 14 leave phase 17's one-rank references and the
    # THREEDPOT snapshot here
    refs = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    mgr = mg_rayio_phase(snap, card, refs.name)
    del snap
    say(f"phase 13: {time.perf_counter() - t0:.1f} s")
    mg_launches = mgr["design"]["launches"]
    torch.cuda.empty_cache()

    # 14. the THREEDPOT path at full width (NFFT 1024, 2^27 particles in two
    # files, rayOrder 10) and its card-vs-CPU trace
    t0 = time.perf_counter()
    tdp = threedpot_phase(refs.name)
    report_threedpot(tdp, card)
    say(f"phase 14: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 15. the j-block streamed synthesis: block counts at orders 10-13, the
    # order-13 step (K1 and K2 at order 13 against their twins, a point
    # mass) and run() with galaxies at order 13
    p15 = stream_phase(dev, card)
    o13 = p15["step"]
    k13 = o13["kernels"]
    k3s = p15["counts"][K3_STREAM[0]]["k3"]
    torch.cuda.empty_cache()

    # 16. the multi-device path on ranks that share the card, and 17. the
    # sharded multigrid step and the slab-decomposed THREEDPOT solve, their
    # ranks in shared spawns
    with tempfile.TemporaryDirectory() as tmp16, \
            tempfile.TemporaryDirectory() as tmp17:
        p16, p17 = run_phases([
            mesh_phase(dev, card, tmp16),
            sharded_phase(dev, card, tmp17, (
                refs.name, tdp["full"]["potential"]["card_coarse"]))],
            dev, tmp16)
    refs.cleanup()
    torch.cuda.empty_cache()
    # the sharded MG step's launches on each rank in its timed plane
    mesh_mg = [r["launches"] for r in p17["mg"]]
    sharded = {k: dict(ranks=P16_HEAD_RANKS,
                       launches_per_rank_per_plane=[
                           [r["launches"].get(k, 0) for r in h["rows"]]
                           for h in p16["heads"]],
                       ms_per_rank_per_plane=[
                           [r[ms] for r in h["rows"]] for h in p16["heads"]])
               for k, ms in (("legendre_analysis", "K1_ms"),
                             ("legendre_synth", "K2_ms"))}

    def entry(name, source, replaces, launches, err, ms, plain_ms, **extra):
        b = bounds[name]
        return dict(name=name, route="cuda",
                    source=f"calclens_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                    bound_by=b["bound_by"], library_ms=None,
                    full_bound_ms=b["full_bound_ms"], floor_ms=b["floor_ms"],
                    **extra)

    # the variant kernels' twins are timed at order 10 (at order 12 they
    # take minutes), their errors are the order-12 row checks
    kernels = [
        entry("legendre_analysis", "legendre_analysis.cu",
              "calclens_tpu/sht/pallas_legendre.py:251",
              h["counts"]["legendre_analysis"], k1[1], k1[2], k1[3],
              sharded=sharded["legendre_analysis"],
              sph_launches=hs["counts"]["legendre_analysis"],
              gals_run_launches=gals_launches["legendre_analysis"],
              mg_launches=mg_launches["legendre_analysis"],
              mesh_mg_launches=[r.get("legendre_analysis", 0)
                                for r in mesh_mg],
              order13=dict(ms=k13["k1_ms"], rows_max_abs_err=k13["k1"][1],
                           launches_per_plane=o13["counts"][0][
                               "legendre_analysis"])),
        entry("legendre_synth", "legendre_synth.cu",
              "calclens_tpu/sht/pallas_legendre_mx.py:124",
              h["counts"]["legendre_synth"], k2[1], k2[2], k2[3],
              sharded=sharded["legendre_synth"],
              sph_launches=hs["counts"]["legendre_synth"],
              gals_run_launches=gals_launches["legendre_synth"],
              order13=dict(ms_per_plane=k13["k2_ms"], windows=k13["nblk"],
                           rows_max_abs_err=max(e[1] for e in
                                                k13["k2"].values()),
                           launches_per_plane=o13["counts"][0][
                               "legendre_synth"])),
        entry("legendre_synth_phi", "legendre_synth.cu",
              "calclens_tpu/sht/pallas_legendre_mx.py:124",
              mg_launches["legendre_synth_phi"], v12["legendre_synth_phi"][1],
              v12["legendre_synth_phi"][2], v10["legendre_synth_phi"][3],
              plain_order=10, alm2map_launches=phi_launches,
              mesh_mg_launches=[r.get("legendre_synth_phi", 0)
                                for r in mesh_mg]),
        entry("legendre_synth_vpu", "legendre_synth_vpu.cu",
              "calclens_tpu/sht/pallas_legendre.py:49",
              hv["counts"]["legendre_synth_vpu"],
              v12["legendre_synth_vpu"][1], v12["legendre_synth_vpu"][2],
              v10["legendre_synth_vpu"][3], plain_order=10,
              sharded_trace_launches={n: v for n, v in p16["traces"].items()},
              streamed=dict(order=K3_STREAM[0], blocks=K3_STREAM[1],
                            launches=k3s[K3_STREAM[1]]["launches"][
                                "legendre_synth_vpu"],
                            maps_rel_err=k3s[K3_STREAM[1]]["err"])),
        entry("legendre_synth_vpu_phi", "legendre_synth_vpu.cu",
              "calclens_tpu/sht/pallas_legendre.py:49",
              phi3_launches, v12["legendre_synth_vpu_phi"][1],
              v12["legendre_synth_vpu_phi"][2],
              v10["legendre_synth_vpu_phi"][3], plain_order=10),
        entry("legendre_chain_seed", "legendre_synth_vpu.cu",
              "calclens_tpu/sht/pallas_legendre.py:49",
              hv["counts"]["legendre_chain_seed"], seed12[0], seed12[1],
              seed12[2]),
        entry("legendre_analysis_dot", "legendre_analysis_dot.cu",
              "calclens_tpu/sht/pallas_legendre.py:477",
              hv["counts"]["legendre_analysis_dot"],
              v12["legendre_analysis_dot"][1],
              v12["legendre_analysis_dot"][2],
              v10["legendre_analysis_dot"][3], plain_order=10),
    ]
    dot = p1["modes"]["dot"]
    kernels.append(dict(
        name="roofline_probe", route="cuda",
        source="calclens_tpu_torch/csrc/roofline_probe.cu",
        replaces="tools/roofline_legendre.py:63", launches=p1["launches"],
        **{k: dot[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        mode="dot", modes=p1["modes"], shape=p1["shape"],
        rec_loop_sass_per_element=p1["rec_loop"]["per_element"]))
    for name, line in (("gather_rows", 67), ("gather_lanes", 96),
                       ("gather_onehot", 125)):
        g = gathers[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="calclens_tpu_torch/csrc/gather_probe.cu",
            replaces=f"tools/exp_pallas_gather.py:{line}",
            launches=g["launches"], max_abs_err=g["max_abs_err"],
            ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
            bound_by=g["bound_by"], library_ms=g["library_ms"],
            sass=g.get("sass")))
    for k in kernels:
        k.setdefault("shares_of_ceilings", None)
        if k["name"] in p1["shares"]:
            _, s_rec, s_rs = p1["shares"][k["name"]]
            k["shares_of_ceilings"] = dict(rec=s_rec, rec_store=s_rs)
        if k["name"] in p1["steady"]:
            st = p1["steady"][k["name"]]
            k["steady_sass_per_element"] = st["per_element"]
            k["steady_sass_cuda_cores_per_element"] = \
                st["cuda_core_per_element"]
    check(all(math.isfinite(k[f]) for k in kernels
              for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
          "non-finite kernel measurement")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on its path: {kernels}")
    report_before(card, {
        ("legendre_analysis", 10): k1_10[2],
        ("legendre_analysis", 12): k1[2],
        ("legendre_analysis", 13): k13["k1_ms"],
        ("legendre_analysis_dot", 10):
            variants10["K4 legendre_analysis_dot"][2],
        ("legendre_analysis_dot", 12): v12["legendre_analysis_dot"][2],
        ("legendre_analysis_dot", 13): k13["k4_ms"]}, {
        "headline": (h["times"], h["peak"]),
        "SPH headline": (hs["times"], hs["peak"]),
        "MG design point": (mgr["design"]["times"][1:],
                            mgr["design"]["peak"]),
        "THREEDPOT": (tdp["full"]["times"][1:], tdp["full"]["peak"]),
        "order 13": (o13["times"][1:], o13["peak"])})
    say(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    say(card)  # nvidia-smi's own line: name, power limit
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
