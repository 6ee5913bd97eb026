#!/usr/bin/env python3
"""Smoke run of photometry_tpu_torch on one CUDA card.

Drives the port's FFI aperture, PSF and prepare paths, bfloat16 cubes,
host-resident cubes streamed through the card, the flux-only stamp
extraction, ECC registration, the default-method drain (both automatic
switches: halo and linPSF), Target Pixel Files through the drain, the
chain catalog -> todo -> drain -> merge, several worker processes draining
one todo list (the task-pull scheduler), the ``--plot`` diagnostics and
the multi-card layer on a mesh of four entries of the one card, through
the entry points a user calls, with JAX, h5py and the JAX package blocked
from import.  Phases run
in the order 0, 1, 2, 2b, 2c, 2d (adversarial), 3, 3b (on phase 3's cube),
3c (phase 3's cube on the host), 2d (main shape, on phase 3's cube and
targets), 4, 11 (a-d, f: phase 3's cubes and phase 4's fits on a mesh), 6
(on phase 3's cube), 8 (beside phase 3's context), 7 (on phase 3's cubes),
11e (phase 7's tasks on a mesh), 3b (the full sector, once phase 3's cubes
are freed), 3c (the full sector in float32 on the host), 5, 9 (on phase
5's store), 10 (with no cube of the parent's on the card).  Cut to keep
the script within half its time limit once phase 11 came: phase 8's
primary TPFs from 128 to 48, and phase 7's profiled leases from two to
one.

0. imports: ``jax``, ``jaxlib``, ``h5py`` and ``photometry_tpu`` refused.
1. device: the card's name and power limit; the five kernel sources are
   built with nvcc for sm_90a from ``photometry_tpu_torch/ops/csrc/``, one
   nvcc each, started together (registers and spills of every kernel
   printed, the band kernel's float32 and bfloat16 instantiations apart).
2. band kernel vs its plain torch version on the card: adversarial inputs
   (NaN pixels, an all-zero frame, NaN err/background, shenanigans flags,
   stamps straddling 64x128 cells), adversarial stamps (a 1-pixel mask, a
   full one, masks on each stamp edge and on its border ring, an empty
   mask, windows cut short, 33x33 stamps flush with the frame, T=37: sums
   against plain with counts exact, two runs bit-equal), then the main
   path's shape (2048x2048 CCD, T=512, 1,024 targets of 17x17 and 33x33)
   with median times (through band_extract_flux_batch, through
   band_sums_cuda, and the kernel alone) beside the bytes bound and the
   bound of the 32-byte sectors the pixels touch.  In bfloat16: the
   adversarial inputs with NaN, +-inf, float32 values that round to inf in
   bfloat16, subnormals and -0 written under the stamps, cast on the card
   (the kernel's sums against plain on the same cube, against the float32
   kernel on the widened cube bit for bit, twice bit-equal), the stamp
   cases, then the main shapes on phase 3's cube cast to bfloat16, timed
   beside both bounds at 2-byte elements.  At Target Pixel File shapes:
   whole 11x11, 15x15 and 21x21 frames at T = 19,728 and 11x11 at T =
   118,080 (planes off 16 bytes, 3,690 blocks on the grid's y axis), in
   both types.
2b. PSF kernel vs its plain torch version on the card: the problems of
   tests/test_psf_pallas.py redrawn, then adversarial instances (NaN
   pixels, an all-NaN stamp, dummy stars, blends, a star clipped at the
   stamp edge; S = 1, 3, 5, 6, 8, K = 1, 3 and 4, stamps 11, 15, 17 and
   32, 0 iterations), then the main path's shape (180 targets x 512
   cadences of 15x15, S=5, K=3, 6 iterations) with median times and two
   bounds: all operations in float32, and the normal equations in 3xTF32
   on the tensor cores.
2c. the 15x15 median and segment-histogram kernels vs their plain torch
   versions on the card, bit for bit: adversarial inputs (a 3.4e38 outlier,
   a constant frame, a 6x5 frame, signed zeros, a few distinct values on a
   2078x2136 frame, negative frames, +-3.4e38 side by side and in blocks,
   denormals, sides that are not multiples of the kernel's 32x32 tile;
   invalid and out-of-range
   samples, empty segments, every sample in one bucket, N % 4 != 0, a
   table too large for shared memory), then the prepare stage's shapes
   ((8, 2048, 2048) frames; 64 frames x 1024^2 samples x the CCD's 39
   rings x 512 buckets, on synthetic buckets and on real ones: phase 3's
   field on phase 5's sky, bucketed by segment_kde_mode's rule) with
   median times of kernel, plain version and the one-call torch
   equivalent.
2d. the stamp-flux kernel vs its plain torch version on the card:
   adversarial inputs (NaN and ±inf pixels, an all-NaN cadence, an empty
   mask, stamps flush with and running past the bottom and right edges;
   N = 1, 7, 9, 40; masks of 1, 17, 33 and 64 px; T = 8, 37 and 512;
   planes that do not start on 16 bytes; crowded targets in reverse frame
   order, two runs bit-equal; the domain's ValueErrors and a mask too large
   for shared memory), then the main shape: ``stamp_extract_flux`` on
   phase 3's (512, 2048, 2048) cube for its 10,240 targets, one 17x17
   window each with the target's K2P2 mask cut to it (the kernel's launch
   count must rise), held against the plain version and against the band
   kernel's flux and finite-count sums, two runs bit-equal, with median
   times of the kernel alone, ``stamp_flux_cuda`` and the plain version
   beside the bytes bound and the 32-byte-sector and 64-byte-segment
   bounds (``stamp_sector_bytes``).
3. the aperture slice at full CCD size: a seeded 12,000-star field (Tmag
   7.5-13), cubes on the card (T=512, ~28 GB), ``SectorContext.from_arrays``,
   ``extract_aperture_batch`` on the 10,240 brightest targets (the band
   kernel's launch count must rise; its launch's arguments are recorded,
   and that launch is run again: sums against plain, two runs bit-equal,
   its times beside both bounds), 1,024 of them re-extracted by the
   plain path, then ``photometry_batch`` on one 256-task lease with
   products read back.
3b. bfloat16 cubes: a context cast on the card from phase 3's cube
   (``SectorContext.from_arrays(..., cube_dtype=torch.bfloat16)``);
   ``extract_aperture_batch`` on the same 10,240 targets (the bfloat16
   instantiation's launch count must rise and the float32 one's must not;
   its launch recorded and held to plain, timed beside its bounds),
   statuses and masks equal to phase 3's, fluxes against phase 3's within
   tests/test_engine_extras.py's sector-scale bounds (p99 |rel| < 1.5e-3,
   median < 5e-4, flux_err p99 < 1e-2); then PSF on 128 targets, linPSF on
   16 and halo on 4, forced by ``method``, the first P7_PARITY of each held
   to a CPU re-run on a host copy of the same bfloat16 cube (PSF: phase 4's
   flux bound on 99% of cadences, the card's kernel against the plain
   fitter; linPSF rtol 1e-4; halo rtol 5e-4).  After phase 7: the full
   primary-mission sector, T = 1,312 in bfloat16 (38.5 GB with the flags)
   made in frame blocks on the card, ``extract_aperture_batch`` on the same
   targets: wall, targets/s, peak memory (below 80 GB) and the band
   launch's time beside its bounds.
3c. host-resident cubes (``cache="host"``): phase 3's float32 cube copied
   to the host, ``SectorContext.from_arrays(..., cache="host")``,
   ``extract_aperture_batch`` on the same 10,240 targets streamed through
   the card 128 frames a chunk (the band kernel launched ceil(T/128)
   times; statuses, masks, APERTURE images and every light-curve array
   bit-equal to phase 3's), then PSF on 128 targets, linPSF on 16 and halo
   on 4 forced by ``method``, bit-equal to the same calls on phase 3's
   device context.  After phase 3b's full sector: the same sector, T =
   1,312, in float32 (71.5 GB with the flags; T is cut, and the cut
   printed, where the host's MemAvailable cannot hold it), made on the card
   from the generator state phase 3b's was made from and copied to
   pageable host memory; the 10,240 targets streamed: targets/s, the
   streamed extraction's wall and host-to-device GB/s beside a plain
   pinned copy's (the bound), under ``torch.profiler`` the copies' busy
   share and the share of the kernel's time they overlap, peak device
   memory (far below the cube), MemTotal/MemAvailable; the same extraction
   with the cube pinned in place (cudaHostRegister), bit-equal; fluxes
   against phase 3b's bfloat16 sector within 3b's bounds, statuses and
   masks equal.  An extended-mission sector at 600 s (T = 3,900, 212.6 GB)
   is not run: it does not fit the card's host.
4. the PSF slice on the same context: a synthetic K=3 table PRF written
   with ``PRF.write_mat`` and read back with ``PRF.from_mat``,
   ``extract_psf_batch`` on the 2,048 brightest targets (the PSF kernel's
   launch count must rise, no group it takes may go to the plain fitter),
   the slice again under ``torch.profiler`` (the kernel's device time,
   first-cadence and warm launches apart, and its share of the slice's
   wall), 128 of them re-fitted by the plain fitter, then one 256-task
   ``method="psf"`` lease through ``photometry_batch`` with products read
   back.
5. the prepare slice at full CCD size: 96 synthetic sector-27 FFIs of
   camera 1 CCD 1 in raw TESS geometry (2078x2136, TAN WCS, the field of
   phase 3 on a sky with a corner glow, one saturated patch), a catalog and
   one TPF (a faint star with two or more faint stars in its 11x11 stamp,
   the stamp's WCS in its APERTURE header), written with
   ``io.fits.write_fits``; ``prepare.prepare_cube``
   runs stages 1-5 on them into an in-memory store with the ``ImageCube``
   methods (one 64-frame chunk and a partial one), under ``torch.profiler``,
   then again with ``calc_movement_kernel=True``, which resumes and runs
   stage 6 alone, profiler off.  Both kernels' launch counts must rise; the
   markers, backgrounds, flags and movement kernels (every one below 0.05 px
   on these motionless frames, below 0.005 px at the reference frame) are
   checked; the first chunk's background fit and 8 frames' residuals are
   re-run with the plain versions and must be equal; stage walls, frames
   per second, the device busy share of stages 1-5, the median and
   histogram kernels' device time per launch and stage 6's peak memory
   (around its call) are printed, with the native host runtime's state
   (the phase fails if it did not load: FITS reads gunzip and byteswap
   through it).
6. ECC registration at full size: 32 copies of phase 3's star field shifted
   on the card by a known drift plus jitter (up to 1.5 px, FFT phase ramps)
   with fresh noise, registered by ``MotionModel.calc_kernels_batch``
   (recovered within 0.05 px); the series then drives the jitter of
   ``extract_aperture_batch`` on 1,024 targets of a context over phase 3's
   cube, whose per-cadence ``pos_corr`` must follow it.
7. the default-method drain at full CCD size, on phase 3's cubes with their
   noise redrawn at a TESS-like level (variance (flux + 100) / 1425.6 s):
   40 bright stars (Tmag 3.5-6.0, a 1% sinusoid, cores clipped at
   SATURATION_FLUX with the charge bled along the column; half 1-2 px
   inside the CCD's edges, half with a 160-row charge tail) and 32
   pairs at 3.5-6.0 px (Tmag 10.0 and 10.3) are injected, a catalog and a
   2,048-task todo.sqlite (method NULL) are written, and ``run_drain(...,
   method=None, batch_size=256)`` runs with ``dispatcher.open_context``
   handing back the phase's context (no h5py here).  Checks: every task
   gets a final status, the band kernel launched once per recorded call,
   each lease's sums equal ``band_sums_plain`` on that lease's own inputs
   (counts exact, sums and aperture outputs within RTOL/ATOL, NaN patterns
   equal), every OK aperture light curve is finite, >= 90% of the bright stars
   end as halo through the automatic switch with both of the engine's
   routes seen ("Stamp resize hit limit", "Too many stamp resizes") and
   light curves correlating > 0.5 with their sinusoid, three halo products
   read back with their WEIGHTMAP, >= 90% of the pair members end as
   linPSF through the deblend switch and >= 90% of those within 5% of the
   injected flux; the drain's first linPSF solve and first TV-min descent
   (P7_PARITY targets each) equal a CPU re-run on copies of their inputs
   (fluxes rtol 1e-4; weights rtol 5e-4, atol 1e-6, objective rel 1e-3).
   Prints the drain's wall and its timers, the halo
   flushes, the linPSF reruns' wall and peak memory, then the drain's
   first lease again under ``torch.profiler``: device busy share and
   top device ops.  Phases 7 and 8 print the native host runtime's state
   (failing if it did not load) and hold one written product to MTIME 0
   in its gzip header and to the same bytes when its HDUs are written
   twice a second apart.

8. Target Pixel Files through the drain: 48 primary TPFs at 120 s (T =
   19,728, 27.4 d; an eighth 21x21 and an eighth 15x15, the rest 11x11) on
   phase 3's field, each star rendered as ``make_field`` renders it, moved
   by a drifting POS_CORR, a 1% sinusoid on each primary, a SPOC aperture,
   4 files gzipped, written with ``io.fits.write_fits``; one 20-s TPF (T =
   118,080); the todo list's TPF rows, primaries and ``tpf:NNN``
   secondaries, from the port's ``todolist.make_todo`` on the phase's
   folder (every TPF read; its wall printed), held equal to those the
   phase finds itself from the stars' positions and the apertures; 256 FFI
   tasks on phase 3's context added to it; ``run_drain(...,
   method=None)`` in leases of 32, so FFI and TPF leases alternate, with
   ``dispatcher.open_context`` handing back phase 3's context for FFI tasks
   only.  Checks: every task gets a final status, TPF primaries end OK,
   WARNING or SKIPPED, each recorded band launch equals ``band_sums_plain``
   on its own inputs, the primaries' median flux within 0.8-1.2 of the
   injected flux and their light curves correlating > 0.5 with the
   sinusoid, ``pos_corr`` on the written POS_CORR re-zeroed at the
   reference time (5e-4 px: two float32 ulps at 2,000 px), one APERTURE
   product with the SPOC bits, the
   20-s light curve > 95% finite with rms_hour below its scatter.  Prints
   the drain's timers, TPF tasks/s with products and the band kernel's
   time at (N=1, T=19,728, 11x11) and (N=1, T=118,080) beside its bytes
   bound.

9. the chain at full CCD size on phase 5's prepared store (96 frames of
   2048x2048, the 12,000-star field): the field as a TIC extract (``.npz``)
   with 64 more stars just off the science area, its catalog built by the
   port's ``cli/catalog_cmd``; the port's ``todolist.make_todo`` over the
   store (``todolist.open_cube`` hands back the in-memory store for the
   cube file's name) and phase 5's TPF: every star on the science area once
   as an ``ffi`` task and none off it, the TPF primary and its ``tpf:NNN``
   secondaries, priorities by Tmag; ``run_drain(..., method=None)`` over
   the 2,048 highest priorities with ``dispatcher.open_context`` handing
   back a ``SectorContext.from_arrays`` over the store: every drained task
   a final status, the band kernel launched; the port's
   ``cli/todo_merge_cmd`` with a corrections file derived as
   tests/test_scheduler_merge_plots.py::test_todo_merge derives one
   (``corr_status``, a ``diagnostics_corr`` table, one drained row's status
   changed): ``corr_status`` NULL on the undrained rows and the changed one
   only, their ``diagnostics_corr`` rows gone.  Prints each step's wall and
   the todo's row count.

10. the task-pull scheduler and the diagnostics, with the parent holding no
   cube on the card (its ``torch.cuda.memory_allocated()`` printed first);
   every kernel was built in phase 1, before any worker starts.  (a) the
   port's ``cli/scheduler_cmd`` with 2 local workers over pipes on a copy
   of phase 8's folder whose todo holds its 16 highest-priority primary
   TPFs and their secondaries: the workers open the TPFs through the real
   ``open_context``; exit 0, drained, every task final, one diagnostics row
   each, every task's status, method and FLUX_RAW equal to phase 8's
   ``run_drain``.  (b) phase 7's traffic (2,048 tasks of a 2048x2048, T =
   512 float32 sector with 40 bright stars and 32 pairs, method NULL,
   leases of 256) on a sector rebuilt from the seed alone
   (``phase10_sector``): first ``run_drain`` in this process (the
   reference; its cube freed after (c)), then N = 1 and N = 2 TCP workers,
   each a process of this script (``phase10_worker``: the import blocker,
   the sector rebuilt on the card, handed back by
   ``dispatcher.open_context``, ``scheduler.worker_remote``) that writes
   its band launches, peak device memory and drain wall to a file at exit;
   the master is ``run_distributed(listen=...)`` here.  Checks: drained,
   every task final, no priority twice in diagnostics, the band kernel
   launched in every worker, no blocked module imported, per task the same
   method and FLUX_RAW as the reference (bit for bit, else within
   ROADMAP's tolerances), no other status difference than SKIPPED (those
   counted), no task both run and SKIPPED.  Tasks/s with products for
   ``run_drain``, N = 1 and N = 2, and each worker's peak memory.  (c) on
   the reference's cube: the K2P2 debug images (``diagnostics.k2p2_debug``)
   of 32 targets on the card equal to the same call on the CPU (above,
   labels, seg, mask; blurred within the blur tolerance); where matplotlib
   imports, ``run_drain(plot=True)`` over 64 tasks with one halo star and
   one linPSF pair: sumimage and masks_flux for every OK aperture task,
   psf_fit for the linPSF ones, the weight maps for the halo one, the
   figures' wall beside the drain's.

11. the multi-card layer on one card: a mesh of four entries of it
   (``make_mesh(..., ["cuda:0"] * 4)``, the counterpart of the JAX suite's
   virtual devices), after phase 4, on phase 3's cubes and targets, beside
   phase 3's and phase 4's walls and phase 3's peak device memory.
   (a) ``SectorContext.from_arrays(..., mesh=time=4)`` on phase 3's
   tensors (four views, checked by their storage) and
   ``extract_aperture_batch`` on the 10,240 targets: 4 band launches, every
   status, mask and light-curve column bit-equal to phase 3's; again at T
   = 510 (three views and a padded copied last shard), against phase 3's
   first 510 cadences; wall and peak memory of each.  (b) (a)'s final masks
   through ``engine._extract_flux_sharded`` on a time=2 x targets=2 mesh:
   4 launches, bit-equal to (a).  (c) ``sharded_psf_fit`` on each of phase
   4's own fit calls (recorded in its timed slice) over 4 shards: the PSF
   kernel launched, each call bit-equal to phase 4's (or, where the split
   changed the arithmetic, 99% of the fluxes within 2e-2, phase 4's
   check).  (d) ``prepare_step`` on 32 frames of phase 3's field on a 150
   e-/s sky (phase 5's floor) at time=4 (tile 64) against ``estimate_background`` -> ``time_moving_nanmean`` ->
   the mean on one device: backgrounds within 1e-5 relative, the sum image
   within 1e-5 of itself plus 1e-5 of the background.  (f) a one-process
   NCCL group: ``multihost.initialize``, ``global_mesh(n_targets=2)`` over
   four entries of the card, ``local_data_slice(8)``, a sharded sum of
   arange(8) through the group's ``all_gather`` (28), ``shutdown``.  (e),
   after phase 7: its first 512 tasks drained by ``run_drain(mesh=...)``
   (time=2 x targets=2; ``open_context`` patched to build the context on
   the mesh it is handed) and without a mesh: per task the same status
   and method, FLUX_RAW bit for bit, 4 band launches a lease against 1.

Prints the wall of each phase, a JSON line of per-kernel results, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero on any failure, without a result, and when no CUDA card is
present.

Usage:  python3 chip_smoke.py [--seed N]
"""

import argparse
import importlib.abc
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-3        # float32 sums in another order (tests/test_bandext.py:41)
H = W = 2048
T = 512                        # sector T=1312 needs ~72 GB of cubes: cut to fit one card
N_STARS, N_TARGETS, N_PLAIN, N_LEASE = 12000, 10240, 1024, 256
N_PSF, N_PSF_PLAIN = 2048, 128
PSF_MAIN = {"N": 180, "h": 15, "S": 5, "K": 3, "n_iters": 6}   # _group_chunks' cap at 15x15
# The tests/test_psf_pallas.py problems are drawn from a fixed seed, as that
# test draws them from PRNGKey(0): a near-degenerate blend in another draw can
# amplify one float32 ulp of JtJ past the test's max bounds, even between the
# plain fitter in float32 and in float64.  In this draw those two agree far
# inside every bound.
PSF_TEST_SEED = 1
KERNELS = {
    "band_extract": ("photometry_tpu_torch/ops/csrc/band_extract.cu",
                     "photometry_tpu/ops/bandext.py:258"),
    # The band kernel's bfloat16 instantiation (bfloat16 cubes, as the TPU
    # kernel reads them), from the same source:
    "band_extract_bf16": ("photometry_tpu_torch/ops/csrc/band_extract.cu",
                          "photometry_tpu/ops/bandext.py:258"),
    "psf_warm_fit": ("photometry_tpu_torch/ops/csrc/psf_warm_fit.cu",
                     "photometry_tpu/models/psf_pallas.py:76"),
    "median15": ("photometry_tpu_torch/ops/csrc/median15.cu",
                 "photometry_tpu/ops/median_pallas.py:62"),
    "segment_hist": ("photometry_tpu_torch/ops/csrc/segment_hist.cu",
                     "photometry_tpu/ops/hist_pallas.py:44"),
    "stamp_flux": ("photometry_tpu_torch/ops/csrc/stamp_flux.cu",
                   "tools/pallas_extract_demo.py:51"),
}
MEDIAN_MAIN = (8, 2048, 2048)            # frames of the shenanigans stage per launch (cut from 64)
HIST_MAIN = (64, 1 << 20, 512)           # a 64-frame chunk at hist_stride 2, 512 buckets
# Phase 5: sector 27 (600 s FFIs: time smoothing over 9 frames), camera 1
# CCD 1 (the camera centre sits off its corner: ~40 rings beyond 2400 px).
PREP = {"T": 96, "sector": 27, "camera": 1, "ccd": 1, "chunk": 64}
# Phase 7: 40 bright stars, 32 pairs, a todo of 2,048 tasks; charge tails of
# the bright stars that must outgrow ten stamp resizes run this many rows.
P7 = {"bright": 40, "pairs": 32, "todo": 2048, "tail": 160}
P7_PARITY = 4                            # targets of phase 7's linPSF and TV-min re-run on the CPU
# Phase 3b: a full primary-mission sector (1,312 frames at 1,800 s) in bfloat16.
T_SECTOR = 1312
# Phase 8: 48 primary TPFs at 120 s over 27.4 d (cut from 128 to make room
# for phase 11), one 20-s TPF, 256 FFI tasks, 4 files gzipped; leases of 32
# so FFI and TPF leases alternate.
P8 = {"tpf": 48, "T": 19728, "fast_T": 118080, "ffi": 256, "gzip": 4, "batch": 32}
RAW_SHAPE = (2078, 2136)                 # raw TESS FFI; science area rows 0:2048, cols 44:2092
# Phase 9: the chain on phase 5's store: the drain takes the 2,048 highest
# priorities; 64 catalog stars lie just off the science area.
P9 = {"todo": 2048, "off": 64, "batch": 256}
# Phase 10: (a) the 16 highest-priority primary TPFs of phase 8 and their
# secondaries; (b) phase 7's 2,048 tasks in leases of 256; (c) the K2P2 debug
# images of 32 targets and a plotted drain of 64 tasks.
P10 = {"tpf": 16, "batch": 256, "debug": 32, "plot": 64}
# NVIDIA H100 SXM data sheet: HBM bytes/s, float32 FLOP/s outside the tensor cores,
# dense TF32 FLOP/s of the tensor cores (3xTF32 spends three products on one).
PEAK_BYTES, PEAK_F32, PEAK_TF32 = 3.35e12, 67e12, 495e12


class _Blocked(importlib.abc.MetaPathFinder):
    """Refuse jax, jaxlib, h5py and the JAX package: the port must run without them."""

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "h5py", "photometry_tpu"):
            raise ImportError(f"{name} is blocked in the smoke run")
        return None


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def native_state(phase) -> str:
    """The native host runtime's state; the phase fails if it did not load."""
    from photometry_tpu_torch import native_ops
    check(native_ops.native_available(), f"phase {phase}: the native host runtime did not load")
    return ("native host runtime loaded, libdeflate "
            + ("linked" if native_ops.libdeflate_linked()
               else "not linked (.gz by the stdlib, MTIME 0)"))


def product_twice(phase, path, folder) -> str:
    """One written ``.fits.gz`` product: MTIME 0 in its gzip header, and
    its HDUs written twice a second apart byte-equal."""
    from photometry_tpu_torch.io import fits as pf
    with open(path, "rb") as fh:
        head = fh.read(8)
    check(head[:2] == b"\x1f\x8b" and head[4:8] == bytes(4),
          f"phase {phase}: {path}: gzip MTIME is not 0")
    hdus = pf.read_fits(path)
    blobs = []
    for k in range(2):
        if k:
            time.sleep(1.1)
        out = os.path.join(folder, f"twice{k}.fits.gz")
        pf.write_fits(out, hdus, gzip_level=2)
        with open(out, "rb") as fh:
            blobs.append(fh.read())
    check(blobs[0] == blobs[1], f"phase {phase}: a product written twice differs")
    return (f"{os.path.basename(path)}: MTIME 0; its HDUs written twice a second apart "
            f"byte-equal ({len(blobs[0])} bytes)")


def cuda_ms(fn, reps=5, warm=True):
    """Median milliseconds of ``fn()`` on the card (CUDA events, after one
    warm-up unless ``warm`` is False: the caller has just run it)."""
    import torch
    if warm:
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_err(got, want, what):
    """Max |got - want| of the extraction outputs; fails outside RTOL/ATOL."""
    worst = 0.0
    for name, a, b in zip(["flux", "ferr", "fbkg", "cent", "shen"], got, want):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype == bool:
            check(np.array_equal(a, b), f"{what}: {name} differs")
            continue
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: {name} NaN pattern differs")
        fin = ~np.isnan(b)
        d = np.abs(a[fin] - b[fin])
        check(bool(np.all(d <= ATOL + RTOL * np.abs(b[fin]))),
              f"{what}: {name} off by up to {d.max():.3g}")
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def host(xs):
    return [x.cpu().numpy() for x in xs]


def adversarial_inputs(rng, T=16, H=128, W=256, N=14, h=17, w=17):
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10, 10] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[2, 20, 20] = np.nan
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    bkgs[4, 30, 30] = np.nan
    flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    r0s[:3], c0s[:3] = [56, 10, 63], [120, 112, 127]       # across 64x128 cell edges
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[:, h // 2, w // 2] = True
    return imgs, errs, bkgs, flags, masks, r0s, c0s


def band_bytes(masks, T, windows=None, elem=4):
    """Bytes band_extract_flux_batch must move: image, err and background
    (``elem`` bytes each: 4 in float32, 2 in bfloat16) under each mask and
    the flags (u8) under each window (the whole stamp without windows) for
    every cadence, the mask bytes once, and the five outputs (3 f32, a 2-f32
    centroid and a bool) per target and cadence."""
    N, h, w = masks.shape
    n_win = N * h * w if windows is None else int(np.asarray(windows).sum())
    return T * (3 * elem * int(masks.sum()) + n_win) + N * h * w + N * T * 21


def band_sector_bytes(masks, r0s, c0s, T, width, windows=None, elem=4):
    """band_bytes with every pixel read counted as the whole 32-byte sector
    it lies in (the card reads no less): per cadence, the sectors of the
    three value planes (``elem``-byte elements) under each mask and of the
    flag plane under each window, each sector once per target.  A frame's
    bytes are a multiple of 32 at the shapes this is used for, so a pixel's
    sector is the same in every cadence."""
    masks = np.asarray(masks, bool)
    N, h, w = masks.shape
    wins = np.ones_like(masks) if windows is None else np.asarray(windows, bool)
    ii, jj = np.mgrid[0:h, 0:w]
    per_cadence = 0
    for n in range(N):
        addr = (int(r0s[n]) + ii) * width + (int(c0s[n]) + jj)
        per_cadence += 3 * 32 * np.unique(addr[masks[n]] // (32 // elem)).size
        per_cadence += 32 * np.unique(addr[wins[n]] // 32).size
    return T * per_cadence + N * h * w + N * T * 21


def stamp_bytes(masks, T):
    """Bytes stamp_flux must move: each in-mask pixel (f32) once per cadence,
    the masks (u8), the corners (2 int32) and the (N, T) float32 output once."""
    N = masks.shape[0]
    return int(masks.sum()) * T * 4 + masks.size + 8 * N + 4 * N * T


def stamp_sector_bytes(masks, r0s, c0s, T, width, height=None, sector=32):
    """Bytes stamp_flux must move, each pixel read counted as the whole
    ``sector``-byte piece of the frame it lies in (32: the card's sectors;
    64: the segments it fetches from device memory): per cadence, the union
    over targets of the pieces under the in-mask pixels inside the frame (a
    piece two windows share is read once), then the masks (u8), the
    corners (2 int32) and the (N, T) float32 output once.  A frame's bytes
    are a multiple of ``sector`` at the shapes this is used for, so a
    pixel's piece is the same in every cadence."""
    masks = np.asarray(masks, bool)
    N, h, w = masks.shape
    ii, jj = np.mgrid[0:h, 0:w]
    sectors = []
    for n in range(N):
        rows, cols = int(r0s[n]) + ii, int(c0s[n]) + jj
        keep = masks[n] & (cols < width)
        if height is not None:
            keep &= rows < height
        sectors.append((rows * width + cols)[keep] // (sector // 4))
    n_sec = np.unique(np.concatenate(sectors)).size if N else 0
    return T * sector * n_sec + N * h * w + 8 * N + 4 * N * T


COUNTS = (1, 2, 8, 9)          # band sums that are counts: exact


def band_sums_err(got, want, what):
    """Max |got - want| of (N, 10, T) band sums: counts exact, sums within
    RTOL/ATOL; fails otherwise."""
    import torch
    got, want = got.double(), want.double()
    for q in range(got.shape[1]):
        a, b = got[:, q], want[:, q]
        if q in COUNTS:
            check(torch.equal(a, b), f"{what}: count q{q} differs")
        else:
            check(bool((a - b).abs().le(ATOL + RTOL * b.abs()).all()),
                  f"{what}: sum q{q} off by up to {(a - b).abs().max().item():.3g}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def band_adversarial(dev, rng, dtype=None):
    """Phase 2's stamp cases for the compacted layout: a 1-pixel mask, a full
    mask, masks on each edge of the stamp and on its border ring, an empty
    mask, windows cut short, 33x33 stamps flush with the frame's edges, and
    T = 37 (not a multiple of the 32-cadence block); the kernel's sums
    against the plain ones, and the same bits twice.  With ``dtype``
    bfloat16, the value planes are cast to it on the card first."""
    import torch
    from photometry_tpu_torch.ops import bandext
    dtype = dtype or torch.float32
    T_, H_, W_, hw = 37, 96, 160, 33
    imgs = rng.normal(100, 5, (T_, H_, W_)).astype(np.float32)
    imgs[2, 40:50, 40:50] = np.nan
    imgs[5] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[7, 10, 10] = np.inf
    bkgs = rng.normal(20, 1, (T_, H_, W_)).astype(np.float32)
    bkgs[9, 60, 60] = np.nan
    flags = (rng.uniform(size=(T_, H_, W_)) < 0.05).astype(np.uint8) * 4
    masks = np.zeros((10, hw, hw), bool)
    masks[0, 16, 16] = True                                  # one pixel
    masks[1] = True                                          # the full stamp
    masks[2, 0, :] = True                                    # each edge alone
    masks[3, -1, :] = True
    masks[4, :, 0] = True
    masks[5, :, -1] = True
    masks[6, [0, -1], :] = True
    masks[6, :, [0, -1]] = True                              # the border ring
    masks[8] = rng.uniform(size=(hw, hw)) < 0.4
    masks[9] = rng.uniform(size=(hw, hw)) < 0.05             # mask 7 stays empty
    windows = np.ones_like(masks)
    windows[7:, :, 25:] = False                              # windows cut short
    masks &= windows
    r0s = np.array([0, H_ - hw, 5, 0, H_ - hw, 30, 1, 60, 17, 0], np.int32)
    c0s = np.array([0, W_ - hw, 7, W_ - hw, 0, 90, 2, 100, 50, 127], np.int32)
    args = [torch.as_tensor(a, device=dev)
            for a in (imgs, errs, bkgs, flags, masks, r0s, c0s)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    err = 0.0
    for win in (None, torch.as_tensor(windows, device=dev)):
        got = bandext.band_sums_cuda(*args, windows=win)
        again = bandext.band_sums_cuda(*args, windows=win)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              "band adversarial: two runs differ")
        err = max(err, band_sums_err(got, bandext.band_sums_plain(*args, windows=win),
                                     "band adversarial stamps"))
    print(f"phase 2 adversarial stamps, {str(dtype)[6:]} (1-pixel, full, edge and border-ring "
          f"masks, an empty mask, windows cut short, {hw}x{hw} flush with the frame, T={T_}): "
          f"kernel sums == plain (counts exact, max |diff| {err:.3g}), two runs bit-equal",
          flush=True)
    return err


def band_launcher(cube, masks, r0s, c0s, windows=None, lib=None):
    """A zero-argument launch of the band kernel (or of ``lib``, a library
    with its entry point) straight to the library, its arguments prepared
    once (no wrapper, no launch count), and the (N, 10, T) output it
    writes: for timing the kernel alone, on the targets in the order given.
    A bfloat16 cube goes to the bfloat16 instantiation."""
    import torch
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    images, errs, bkgs, flags = cube
    T_, H_, W_ = images.shape
    N, h, w = masks.shape
    win = torch.ones_like(masks, dtype=torch.bool) if windows is None else windows.bool()
    mw = (masks.to(torch.uint8) | (win.to(torch.uint8) << 1)).contiguous()
    bbox = bandext._window_bbox(mw)
    out = torch.empty(N, bandext.NQ, T_, device=images.device)
    lib = lib or BAND_EXTRACT.lib()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    args = (mw, r0s, c0s, bbox, out)               # alive as long as the launcher
    entry = getattr(lib, "band_extract_sums_bf16" if images.dtype == torch.bfloat16
                    else "band_extract_sums")

    def launch():
        check(entry(*(x.data_ptr() for x in cube + args), N, T_, H_, W_, h, w, stream) == 0,
              "band_extract_sums launch")
    return launch, out


def band_main_phase(captured, card, phase="3"):
    """The main path's own band launch again (phase 3's, or ``phase``'s), on
    the arguments the path gave it: the kernel's sums against the plain
    ones, twice bit-equal, and its times (alone and through band_sums_cuda)
    beside both bounds (at the cube's element size).  Returns (ms alone,
    bytes bound ms, sector bound ms, max |diff|)."""
    import torch
    from photometry_tpu_torch.ops import bandext
    check(len(captured) == 1, f"phase {phase} recorded {len(captured)} band launches, not 1")
    (a, kw), = captured
    images, errs, bkgs, flags, masks, r0s, c0s = a[:7]
    windows = a[7] if len(a) > 7 else kw.get("windows")
    cube = (images, errs, bkgs, flags)
    got = bandext.band_sums_cuda(*cube, masks, r0s, c0s, windows)
    check(torch.equal(got.view(torch.int32), bandext.band_sums_cuda(
        *cube, masks, r0s, c0s, windows).view(torch.int32)),
        f"phase {phase} band main path: two runs differ")
    err = band_sums_err(got, bandext.band_sums_plain(*cube, masks, r0s, c0s, windows),
                        f"phase {phase} band main path")
    launch, _ = band_launcher(cube, masks, r0s, c0s, windows)
    alone = cuda_ms(launch)
    wrapped = cuda_ms(lambda: bandext.band_sums_cuda(*cube, masks, r0s, c0s, windows))
    m, w_ = masks.cpu().numpy(), None if windows is None else windows.cpu().numpy()
    r, c = r0s.cpu().numpy(), c0s.cpu().numpy()
    T_, _, W_ = images.shape
    elem = images.element_size()
    bound = band_bytes(m, T_, w_, elem) / PEAK_BYTES * 1e3
    sector = band_sector_bytes(m, r, c, T_, W_, w_, elem) / PEAK_BYTES * 1e3
    print(f"phase {phase} band kernel on the main path's launch ({str(images.dtype)[6:]} cube, "
          f"{m.shape[0]} targets, stamps {m.shape[1]}x{m.shape[2]}, {int(m.sum())} mask pixels, "
          f"T={T_}): kernel alone {alone:.3f} ms (targets in catalog order), band_sums_cuda "
          f"{wrapped:.3f} ms (frame order); bound {bound:.3f} ms by bytes, {sector:.3f} ms by "
          f"32-byte sectors; sums == plain (counts exact, max |diff| {err:.3g}), two runs "
          f"bit-equal ({card})", flush=True)
    return alone, bound, sector, err


def bf16_adversarial(dev, rng):
    """Phase 2 in bfloat16: ``adversarial_inputs`` with the values bfloat16
    treats apart written under the stamps (NaN, +-inf, float32 values that
    round to inf in bfloat16, subnormals, -0, and a frame of -0), cast to
    bfloat16 on the card.  The bfloat16 kernel's sums against the plain ones
    on the same cube (counts exact), against the float32 kernel on that cube
    widened (bit for bit: the same pixels summed in the same order), and
    the same bits twice; then ``band_adversarial``'s stamp cases in
    bfloat16.  Returns the max |diff| against plain."""
    import torch
    from photometry_tpu_torch.ops import bandext
    imgs, errs, bkgs, flags, masks, r0s, c0s = adversarial_inputs(rng)
    h, w = masks.shape[1:]
    special = np.array([np.nan, np.inf, -np.inf, 3.397e38, -3.397e38,
                        np.finfo(np.float32).max, 1e-39, -1e-40, 1e-45, -0.0], np.float32)
    for k, plane in enumerate((imgs, errs, bkgs)):   # under each target's central pixel
        for n, v in enumerate(special):
            plane[6 + k, r0s[n] + h // 2, c0s[n] + w // 2] = v
    imgs[9] = -0.0
    cube = [torch.as_tensor(a, device=dev) for a in (imgs, errs, bkgs)]
    cube16 = [x.to(torch.bfloat16) for x in cube]
    wide = [x.to(torch.float32) for x in cube16]
    rest = [torch.as_tensor(a, device=dev) for a in (flags, masks, r0s, c0s)]
    win = torch.zeros_like(rest[1])
    win[:, 1:-1, 2:] = True
    err = 0.0
    for windows in (None, win):
        got = bandext.band_sums_cuda(*cube16, *rest, windows)
        again = bandext.band_sums_cuda(*cube16, *rest, windows)
        f32 = bandext.band_sums_cuda(*wide, *rest, windows)
        torch.cuda.synchronize()
        check(bit_equal(got, again), "bfloat16 adversarial: two runs differ")
        check(bit_equal(got, f32), "bfloat16 adversarial: the bfloat16 kernel differs from the "
              "float32 kernel on the widened cube")
        err = max(err, band_sums_err(got, bandext.band_sums_plain(*cube16, *rest, windows),
                                     "bfloat16 adversarial"))
    print(f"phase 2 bfloat16 adversarial (NaN, +-inf, values past bfloat16's range, subnormals, "
          f"-0 and a -0 frame, with and without windows): kernel sums == plain on the same "
          f"bfloat16 cube (counts exact, max |diff| {err:.3g}), == the float32 kernel on the "
          f"widened cube bit for bit, two runs bit-equal", flush=True)
    return max(err, band_adversarial(dev, rng, torch.bfloat16))


def band_tpf_shapes(dev, gen):
    """Phase 2 at Target Pixel File shapes: whole 11x11, 15x15 and 21x21
    frames at T = 19,728 (a 120-s sector) and 11x11 at T = 118,080 (a 20-s
    one): planes that do not start on 16 bytes (484 bytes a frame in
    float32, 242 in bfloat16) and 3,690 blocks on the grid's y axis, in
    float32 and in bfloat16, the kernel's sums against plain, twice
    bit-equal.  Returns the max |diff|."""
    import torch
    from photometry_tpu_torch.ops import bandext
    err, cases = 0.0, []
    for side, T_ in ((11, 19728), (15, 19728), (21, 19728), (11, 118080)):
        imgs = 100.0 + 5.0 * torch.randn(T_, side, side, device=dev, generator=gen)
        imgs[7, side // 2, side // 2] = float("nan")
        errs = torch.sqrt(imgs.abs()) + 1.0
        bkgs = 20.0 + torch.randn(T_, side, side, device=dev, generator=gen)
        flags = (torch.rand(T_, side, side, device=dev, generator=gen) < 0.01).to(torch.uint8) * 4
        masks = torch.rand(1, side, side, device=dev, generator=gen) < 0.4
        masks[0, side // 2 - 1:side // 2 + 2, side // 2 - 1:side // 2 + 2] = True
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            cube = [x.to(dtype) for x in (imgs, errs, bkgs)] + [flags]
            got = bandext.band_sums_cuda(*cube, masks, zero, zero)
            check(bit_equal(got, bandext.band_sums_cuda(*cube, masks, zero, zero)),
                  f"band TPF shape {side}x{side} T={T_}: two runs differ")
            err = max(err, band_sums_err(got, bandext.band_sums_plain(*cube, masks, zero, zero),
                                         f"band TPF shape {side}x{side} T={T_} {dtype}"))
        cases.append(f"{side}x{side} T={T_}")
    print(f"phase 2 TPF shapes ({', '.join(cases)}; float32 and bfloat16): kernel sums == plain "
          f"(counts exact, max |diff| {err:.3g}), two runs bit-equal", flush=True)
    return err


def bf16_main(shapes, cube, card, result, adv_err):
    """Phase 2's main shapes again on phase 3's cube cast to bfloat16 on the
    card (12.9 GB): the same targets and masks, the bfloat16 kernel's sums
    against plain on the same cube (counts exact), twice bit-equal, its
    times (through band_extract_flux_batch, band_sums_cuda and alone, and
    the plain version's) beside the bytes and 32-byte-sector bounds at
    2-byte elements."""
    import torch
    from photometry_tpu_torch.core.engine import extract_flux_core
    from photometry_tpu_torch.ops import bandext
    images, errs, bkgs, flags = cube
    cube16 = tuple(x.to(torch.bfloat16) for x in (images, errs, bkgs)) + (flags,)
    torch.cuda.synchronize()
    err, kern_ms, plain_ms, bound = adv_err, {}, {}, {}
    for hw, (masks, r0s, c0s, m_args) in shapes.items():
        sums = bandext.band_sums_cuda(*cube16, *m_args)
        check(bit_equal(sums, bandext.band_sums_cuda(*cube16, *m_args)),
              f"bfloat16 main shape {hw}x{hw}: two runs differ")
        err = max(err, band_sums_err(sums, bandext.band_sums_plain(*cube16, *m_args),
                                     f"bfloat16 band sums main shape {hw}x{hw}"))
        launch, _ = band_launcher(cube16, *m_args)
        alone = cuda_ms(launch)
        wrapped = cuda_ms(lambda: bandext.band_sums_cuda(*cube16, *m_args))
        kern_ms[hw] = cuda_ms(lambda: bandext.band_extract_flux_batch(*cube16, *m_args, hw, hw))
        plain_ms[hw] = cuda_ms(lambda: extract_flux_core(*cube16, *m_args, hw, hw))
        bound[hw] = band_bytes(masks, T, elem=2) / PEAK_BYTES * 1e3
        sector = band_sector_bytes(masks, r0s, c0s, T, W, elem=2) / PEAK_BYTES * 1e3
        print(f"phase 2 bfloat16 main shape ({T}, {H}, {W}), {N_PLAIN} targets {hw}x{hw}: "
              f"band_extract_flux_batch {kern_ms[hw]:.3f} ms (band_sums_cuda {wrapped:.3f}, the "
              f"kernel alone {alone:.3f}), plain {plain_ms[hw]:.3f} ms (median of 5), bound "
              f"{bound[hw]:.3f} ms by bytes, {sector:.3f} ms by 32-byte sectors at 2-byte "
              f"elements; sums == plain (counts exact), two runs bit-equal ({card})", flush=True)
    result["band_extract_bf16"].update(max_abs_err=err, ms=kern_ms[17], plain_ms=plain_ms[17],
                                       bound_ms=bound[17], bound_by="bytes")
    del cube16
    torch.cuda.empty_cache()


def make_field(rng):
    """Seeded sum-image star field (bench.make_field): rows, cols, tmag, image."""
    rows = rng.uniform(10, H - 10, N_STARS)
    cols = rng.uniform(10, W - 10, N_STARS)
    tmag = np.sort(rng.uniform(7.5, 13.0, N_STARS))
    flux = np.clip(10 ** (-0.4 * (tmag - 20.451)), 0, None)
    img0 = rng.normal(0.0, 1.5, (H, W)).astype(np.float32)
    win = 7
    yy, xx = np.mgrid[-win:win + 1, -win:win + 1]
    for r, c, f in zip(rows, cols, flux):
        ri, ci = int(r), int(c)
        g = f * np.exp(-0.5 * ((yy + ri - r) ** 2 + (xx + ci - c) ** 2) / 1.2 ** 2)
        g *= 1.0 / (2 * np.pi * 1.2 ** 2)
        r0, r1 = max(ri - win, 0), min(ri + win + 1, H)
        c0, c1 = max(ci - win, 0), min(ci + win + 1, W)
        img0[r0:r1, c0:c1] += g[(r0 - ri + win):(r1 - ri + win), (c0 - ci + win):(c1 - ci + win)]
    return rows, cols, tmag, img0


def make_cubes(img0, gen, dev):
    """(T, H, W) images, err, background, flags on the card, made there in T-chunks."""
    import torch
    base = torch.as_tensor(img0, device=dev)
    sigma = torch.sqrt(torch.clamp(base, min=0.0) + 25.0)
    images = torch.empty(T, H, W, device=dev)
    errs = torch.empty(T, H, W, device=dev)
    bkgs = torch.empty(T, H, W, device=dev)
    flags = torch.empty(T, H, W, device=dev, dtype=torch.uint8)
    for t0 in range(0, T, 64):
        n = min(64, T - t0)
        images[t0:t0 + n] = base + sigma * torch.randn(n, H, W, device=dev, generator=gen)
        errs[t0:t0 + n] = sigma
        bkgs[t0:t0 + n] = 20.0 + torch.randn(n, H, W, device=dev, generator=gen)
        flags[t0:t0 + n] = (torch.rand(n, H, W, device=dev, generator=gen) < 1e-4).to(torch.uint8) * 4
    for cube in (images, errs, bkgs):            # scattered NaN pixels
        idx = torch.randint(0, T * H * W, (2000,), device=dev, generator=gen)
        cube.view(-1)[idx] = float("nan")
    return images, errs, bkgs, flags


# --- PSF helpers ------------------------------------------------------------

def prf_density(terms, oversample=9, radius=8.0):
    """Oversampled PRF density: a normalised sum of axis-aligned Gaussians
    (weight, sigma_row, sigma_col); each term is one separable SVD term."""
    m = int(radius * oversample)
    offs = np.arange(-m, m + 1) / oversample
    g = np.zeros((2 * m + 1, 2 * m + 1))
    for a, sy, sx in terms:
        g += a * np.exp(-0.5 * (offs[:, None] / sy) ** 2 - 0.5 * (offs[None, :] / sx) ** 2)
    return g / (g.sum() / oversample ** 2)


PRF_TERMS = {1: [(1.0, 1.2, 1.2)], 3: [(0.7, 1.1, 1.1), (0.3, 2.0, 2.0), (0.2, 1.6, 1.3)],
             4: [(0.6, 1.0, 1.2), (0.3, 2.2, 1.5), (0.2, 1.4, 2.6), (0.1, 3.0, 0.8)]}


def table_prf(PRF, folder, K, dev):
    """A K-term table PRF, written as a TESS .mat file and read back."""
    path = os.path.join(folder, f"tess2018-k{K}-1-1-characterized-prf.mat")
    PRF.write_mat(path, [prf_density(PRF_TERMS[K])], [1024.0], [1024.0])
    prf = PRF.from_mat(path, sector=1, camera=1, ccd=1, stamp=(0, 15, 0, 15), device=dev)
    check(prf._svd_factors()[0].shape[1] == K, f"table PRF has {prf._svd_factors()[0].shape[1]} "
          f"SVD terms, wanted {K}")
    return prf


def render(prf, rows, cols, flux, h, w):
    import torch
    par = torch.as_tensor(np.stack([rows, cols, flux], -1), dtype=torch.float32, device=prf.device)
    return prf.integrate_to_image(par, (h, w), 5.0).cpu().numpy()


def psf_jaxtest_problem(rng, prf, B, S, h=11, w=11):
    """tests/test_psf_pallas.py:_problem redrawn with numpy: S stars in a
    +-2 px box, fluxes 800-3800, noise 0.8, start 0.25 off, the last star a
    dummy on every third instance, main target star 0."""
    rows = 5.0 + rng.uniform(-2, 2, (B, S))
    cols = 5.0 + rng.uniform(-2, 2, (B, S))
    flux = 800.0 + 3000.0 * rng.uniform(size=(B, S))
    imgs = render(prf, rows, cols, flux, h, w) + 5.0 + 0.8 * rng.normal(size=(B, h, w))
    p_true = np.concatenate([rows, cols, flux], 1)
    p0 = p_true + 0.25 * rng.normal(size=p_true.shape)
    valid = np.ones((B, S), bool)
    valid[::3, S - 1] = False
    mini = np.zeros((B, h, w), bool)
    mini[:, 3:8, 3:8] = True
    onehot = np.zeros((B, S), np.float32)
    onehot[:, 0] = 1.0
    return [imgs.astype(np.float32), np.full((B, h, w), 2.0, np.float32),
            p0.astype(np.float32), valid, mini, onehot]


def psf_instances(rng, prf, B, S, h, w, n_cfg=None, nan_frac=0.0, blend=False):
    """B fit instances shaped like the PSF path's: the target within 0.5 px
    of the stamp centre, 0..S-1 neighbours 2.5-5 px away (0.8-1.5 px when
    ``blend``) and up to 5 mag fainter, dummy slots at -1000 with no flux,
    Poisson-like noise on a background, and a start 0.15 px / 5% off the
    truth (the warm-start role).  ``n_cfg`` star fields repeat over the
    instances, as one target's field repeats over its cadences."""
    n_cfg = n_cfg or B
    rows = np.full((n_cfg, S), -1000.0)
    cols = np.full((n_cfg, S), -1000.0)
    flux = np.zeros((n_cfg, S))
    valid = np.zeros((n_cfg, S), bool)
    n_real = rng.integers(1, S + 1, n_cfg)
    for i in range(n_cfg):
        rows[i, 0] = (h - 1) / 2 + rng.uniform(-0.5, 0.5)
        cols[i, 0] = (w - 1) / 2 + rng.uniform(-0.5, 0.5)
        flux[i, 0] = 10 ** (-0.4 * (rng.uniform(8, 12) - 20.451))
        valid[i, 0] = True
        for s in range(1, n_real[i]):
            ang = rng.uniform(0, 2 * np.pi)
            rad = rng.uniform(0.8, 1.5) if blend else rng.uniform(2.5, 5.0)
            rows[i, s] = rows[i, 0] + rad * np.sin(ang)
            cols[i, s] = cols[i, 0] + rad * np.cos(ang)
            flux[i, s] = flux[i, 0] * 10 ** (-0.4 * rng.uniform(-1, 5))
            valid[i, s] = True
    idx = np.arange(B) % n_cfg
    rows, cols, flux, valid = rows[idx], cols[idx], flux[idx], valid[idx]
    model = render(prf, rows, cols, flux, h, w)
    bkg = rng.uniform(50, 200, (B, 1, 1)) * np.ones((1, h, w))
    imgs = (model + rng.normal(size=model.shape) * np.sqrt(model + bkg + 100.0)).astype(np.float32)
    if nan_frac:
        imgs[rng.uniform(size=imgs.shape) < nan_frac] = np.nan
    jit = np.where(valid, 1.0, 0.0)
    p0 = np.concatenate([rows + jit * rng.normal(0, 0.15, rows.shape),
                         cols + jit * rng.normal(0, 0.15, cols.shape),
                         flux * (1 + jit * rng.normal(0, 0.05, flux.shape))], 1)
    mini = np.zeros((B, h, w), bool)
    mini[:, h // 2 - 1:h // 2 + 2, w // 2 - 1:w // 2 + 2] = True
    onehot = np.zeros((B, S), np.float32)
    onehot[:, 0] = 1.0
    return [imgs, bkg.astype(np.float32), p0.astype(np.float32), valid, mini, onehot]


def psf_fit_check(got, want, valid, S, tier, what):
    """Kernel vs plain under the bounds of tests/test_psf_pallas.py.

    ``tight`` (test_fused_matches_xla_fitter, for its own problems): valid
    positions within 2e-3 px, fluxes within 0.1% at the 95th percentile and
    2% at most, flux_ap to rtol 2e-2 / atol 2, fluxvar to rtol 2e-2.
    ``crowded`` (test_fused_crowded_s6_matches_xla): positions within 5e-3 px
    and fluxes within 0.5% at the 90th percentile.  Realistic instances get
    ``crowded``: with faint neighbours and blends, two float32 orders of the
    plain fitter alone differ by more than the max bounds (one ulp of JtJ
    amplified over the iterations).  Both ways: NaN patterns equal.
    Returns the largest |diff| of the compared outputs (for ``tight``; 0
    for ``crowded``, whose tails are bounded by percentiles only)."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    for k in g:
        check(np.array_equal(np.isnan(g[k]), np.isnan(w[k])), f"{what}: {k} NaN pattern differs")
    vm = np.asarray(valid)
    pos = np.abs(g["params"][:, :2 * S] - w["params"][:, :2 * S])[np.concatenate([vm, vm], 1)]
    fw = w["params"][:, 2 * S:][vm]
    rel = np.abs(g["params"][:, 2 * S:][vm] - fw) / np.maximum(fw, 10.0)
    if tier == "tight":
        check(pos.max() < 2e-3, f"{what}: position off by {pos.max():.3g} px")
        check(np.percentile(rel, 95) < 1e-3 and rel.max() < 2e-2,
              f"{what}: fluxes off by {np.percentile(rel, 95):.3g} (p95), {rel.max():.3g} (max)")
        for k, atol in (("flux_ap", 2.0), ("fluxvar_target", 0.0)):
            d = np.abs(g[k] - w[k])
            check(bool(np.all(d <= atol + 2e-2 * np.abs(w[k]))), f"{what}: {k} off by {d.max():.3g}")
    else:
        check(np.percentile(pos, 90) < 5e-3 and np.percentile(rel, 90) < 5e-3,
              f"{what}: p90 position {np.percentile(pos, 90):.3g} px, flux {np.percentile(rel, 90):.3g}")
    worst = max(float(np.nanmax(np.abs(g[k] - w[k]))) for k in g) if tier == "tight" else 0.0
    print(f"phase 2b {what}: kernel == plain ({tier}; position max {pos.max():.3g} px, "
          f"p90 {np.percentile(pos, 90):.3g}; flux rel p95 {np.percentile(rel, 95):.3g}, "
          f"max {rel.max():.3g})", flush=True)
    return worst


def psf_flops(B, S, K, h, w, n_iters):
    """Floating-point operations of psf_warm_fit on B instances, counted
    from the first kernel's code (an FMA is 2), as (normal equations, rest):
    per iteration and for the final pass, per pixel, the 3S(3S+1)/2 + 3S
    normal-equation FMAs (with the weight products); the rest is the
    weights once, per iteration and for the final pass the axis tables
    (Catmull-Rom weights and K-term taps, values and derivatives, per star
    and row/column), per pixel and star the cutoff, the K-term render and
    the Jacobian row, then the damped Cholesky and two triangular solves
    and the update, and at the end the covariance Cholesky and the S
    inverse columns.  The same count of the same work whatever implements
    it."""
    P3 = 3 * S
    npix = h * w
    normal = B * (n_iters + 1) * npix * (P3 * (P3 + 1) + 3 * P3)
    axis = S * (h + w) * (64 + 16 * K + 4)
    pixel = npix * (S * (10 + 6 * K) + 1)
    chol = 2 * P3 ** 3 // 3 + 3 * P3
    step = axis + pixel + chol + 2 * P3 ** 2 + 10 * S
    final = axis + pixel + 2 * npix + chol + S * P3 ** 2
    return normal, B * (5 * npix + n_iters * step + final)


def psf_bytes(B, S, h, w):
    """Bytes psf_warm_fit must move: images and backgrounds (f32) and the
    MOMF mask (u8) per pixel, p0, valid (u8) and onehot per star, and
    params, flux_ap and fluxvar out."""
    return B * (9 * h * w + 12 * S + S + 4 * S + 12 * S + 8)


def ptxas_summary(log):
    """'S,K: registers/spill-store bytes' of each psf_warm_fit_kernel<S, K>."""
    out, cur, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"psf_warm_fit_kernelILi(\d)ELi(\d)E", line)
        if m and "Compiling entry" in line:
            cur = f"{m.group(1)},{m.group(2)}"
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{cur}:{regs}r/{spill}B")
            cur = None
    return " ".join(sorted(out))


def ptxas_regs(log, names):
    """'name: registers/spill-store bytes' of each named kernel in a ptxas -v log."""
    out, cur, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((n for n in names if n in line), None)
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "Used" in line:
            out.append(f"{cur}:{re.search(r'Used (\d+) registers', line).group(1)}r/{spill}B")
            cur = None
    return " ".join(out)


def reset_counts():
    """Every kernel's launch count to 0, just before a main path runs."""
    from photometry_tpu_torch.ops._kernels import KERNELS
    for kernel in KERNELS:
        kernel.launches = 0


def bit_equal(a, b) -> bool:
    """Float tensors equal bit for bit (signed zeros included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# --- phase 2c: median and histogram kernels ----------------------------------

def median_unfold(x):
    """The one-call torch equivalent of the 15x15 median, one call per frame
    (the unfolded copy of one 2048^2 frame is ~3.8 GB)."""
    from photometry_tpu_torch.ops.median15 import _symmetric_pad
    out = []
    for f in range(x.shape[0]):
        p = _symmetric_pad(x[f:f + 1], 7)[0]
        out.append(p.unfold(0, 15, 1).unfold(1, 15, 1).reshape(x.shape[1], x.shape[2], 225)
                   .median(dim=-1).values)
    return out


def median_phase(dev, rng, gen, card, result):
    import torch
    from photometry_tpu_torch.ops import median15 as m15
    f32 = np.float32
    outl = rng.normal(100.0, 1.0, (2, 40, 40)).astype(f32)
    outl[0, 20, 20] = 3.4028235e38                 # nan_to_num of +inf
    outl[1, 20, 21] = -3.4028235e38
    outl[1, :18, :18] = 7.0                        # an all-equal region
    cases = {"3.4e38 outliers and a flat region": outl,
             "constant frame": np.full((1, 64, 96), 42.0, f32),
             "6x5 frames": rng.normal(5.0, 2.0, (3, 6, 5)).astype(f32),
             "signed zeros 33x47": rng.choice([0.0, -0.0, 1.0, -1.0], (2, 33, 47)).astype(f32),
             "1x1 frame": np.array([[[3.0]]], f32)}
    adv = np.random.default_rng(12)
    huge = adv.normal(0.0, 1.0, (1, 131, 257)).astype(f32)
    huge[0, 20, 20], huge[0, 20, 21] = 3.4028235e38, -3.4028235e38   # side by side
    huge[0, 40:52, 40:52] = 3.4028235e38           # windows whose median is +-3.4e38
    huge[0, 40:52, 52:64] = -3.4028235e38
    cases.update({
        "a few distinct values 2078x2136": adv.choice([1.0, 2.0, 3.0, 5.0], (1, 2078, 2136),
                                                      p=[0.6, 0.2, 0.1, 0.1]).astype(f32),
        "negative frames 131x257": adv.normal(-50.0, 20.0, (2, 131, 257)).astype(f32),
        "+-3.4e38 side by side and in blocks 131x257": huge,
        "denormals and zeros 70x90": np.where(adv.uniform(size=(1, 70, 90)) < 0.2, 0.0,
                                              adv.normal(0.0, 1e-39, (1, 70, 90))).astype(f32),
        "only -0.0 and +0.0 80x70": adv.choice([0.0, -0.0], (1, 80, 70)).astype(f32)})
    for name, x in cases.items():
        xt = torch.as_tensor(x, device=dev)
        got = m15.median15_cuda(xt)
        torch.cuda.synchronize()
        check(bit_equal(got, m15.median_filter_plain(xt)), f"median15 {name}: kernel != plain")
    print(f"phase 2c median15 adversarial ({', '.join(cases)}): kernel == plain bit for bit",
          flush=True)

    nf, H, W = MEDIAN_MAIN
    x = 100.0 + 30.0 * torch.randn(nf, H, W, device=dev, generator=gen)
    idx = torch.randint(0, x.numel(), (4000,), device=dev, generator=gen)
    x.view(-1)[idx] = torch.finfo(torch.float32).max
    got = m15.median15_cuda(x)
    torch.cuda.synchronize()
    check(bit_equal(got, m15.median_filter_plain(x)), "median15 main shape: kernel != plain")
    lib_eq = all(bit_equal(a, b) for a, b in zip(median_unfold(x[:1]), got[:1]))
    ms = cuda_ms(lambda: m15.median15_cuda(x))
    plain_ms = cuda_ms(lambda: m15.median_filter_plain(x), reps=1, warm=False)
    lib_ms = cuda_ms(lambda: median_unfold(x), reps=1)
    nbytes = 2 * x.numel() * 4
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"phase 2c median15 main shape {MEDIAN_MAIN}: kernel == plain bit for bit; kernel "
          f"{ms:.3f} ms ({ms / nf:.3f} ms/frame), plain {plain_ms:.3f} ms, unfold+median "
          f"{lib_ms:.3f} ms (equal: {lib_eq}), bound {bound:.4f} ms by bytes "
          f"({nbytes / 1e6:.1f} MB) ({card})", flush=True)
    result["median15"].update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by="bytes", library_ms=lib_ms)


def sky_buckets(img0, seg_t, nf, nb, gen):
    """(nf, N) buckets and good flags of ``nf`` frames of the star field
    ``img0`` on phase 5's sky (camera 1 CCD 1: a 150 e-/s floor and a glow
    to 550 e-/s towards the far corner, drifting 5%) with Poisson-like
    noise, sampled at stride 2 and bucketed by ``stats.segment_kde_mode``'s
    rule: log10(img + zeropoint) over each frame's range of good samples,
    ``nb`` buckets."""
    import torch
    from photometry_tpu_torch.ops.background import radial_coordinates
    dev = seg_t.device
    r = radial_coordinates(img0.shape, PREP["camera"], PREP["ccd"])
    glow = torch.as_tensor((150.0 + 400.0 * np.exp(-(r.max() - r) / 200.0)).astype(np.float32),
                           device=dev)
    stars = torch.as_tensor(img0, device=dev)
    b = torch.empty(nf, seg_t.numel(), dtype=torch.int32, device=dev)
    good = torch.empty(nf, seg_t.numel(), dtype=torch.bool, device=dev)
    for k in range(nf):
        signal = stars + glow * float(1.0 + 0.05 * np.sin(2 * np.pi * k / PREP["T"]))
        frame = signal + torch.sqrt(torch.clamp(signal, min=0.0) / 480.0 + 0.01) * torch.randn(
            signal.shape, device=dev, generator=gen)
        v = torch.log10(frame - frame.min() + 1.0)[::2, ::2].reshape(-1)
        good[k] = torch.isfinite(v) & (seg_t >= 0)
        vg = v[good[k]]
        lo, span = vg.min(), torch.clamp(vg.max() - vg.min(), min=1e-30)
        b[k] = torch.clamp(((v - lo) / span * nb).to(torch.int32), 0, nb - 1)
    return b, good


def hist_cases(dev, rng, img0):
    """Phase 2c's main-shape inputs: the ring of every stride-2 sample of
    camera 1 CCD 1 (-1 inside 2,400 px), its ring count, and two cases of
    (name, buckets, good) over HIST_MAIN's frames: synthetic sky buckets
    around 180 +- 12 with a 5% tail and 10% bad samples, and the real
    buckets of ``sky_buckets``."""
    import torch
    from photometry_tpu_torch.ops.background import _ring_geometry, radial_coordinates
    nf, ns, nb = HIST_MAIN
    r_host, bins, _, _ = _ring_geometry(radial_coordinates((2048, 2048), 1, 1), 2400, 15)
    S = len(bins) - 1
    ring = np.clip(((r_host - np.float32(2400)) / np.float32(15)).astype(np.int32), -1, S - 1)
    ring = np.where(r_host < 2400, -1, ring)[::2, ::2].reshape(-1).astype(np.int32)
    check(ring.size == ns, "ring image size")
    seg_t = torch.as_tensor(ring, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 30)))
    # Sky samples pile into the buckets around the mode, stars into a long tail:
    sky = 180.0 + 12.0 * torch.randn(nf, ns, device=dev, generator=gen)
    tail = torch.rand(nf, ns, device=dev, generator=gen) < 0.05
    val = torch.where(tail, 180.0 + 330.0 * torch.rand(nf, ns, device=dev, generator=gen), sky)
    del sky, tail
    cases = [("main shape", val.clamp(0, nb - 1).to(torch.int32),
              torch.rand(nf, ns, device=dev, generator=gen) > 0.1)]
    del val
    cases.append(("real buckets", *sky_buckets(img0, seg_t, nf, nb, gen)))
    return seg_t, S, cases


def hist_phase(dev, rng, card, result, img0):
    import torch
    from photometry_tpu_torch.ops import seghist
    from photometry_tpu_torch.ops._kernels import KernelError

    def pair(seg, b, good, S, B):
        args = [torch.as_tensor(a, device=dev) for a in (seg, b, good)]
        got = seghist.segment_histogram_cuda(*args, S, B)
        torch.cuda.synchronize()
        check(torch.equal(got, seghist.segment_histogram_plain(*args, S, B)),
              f"segment_hist {S}x{B}: kernel != plain")

    n = 100_003
    seg = rng.integers(-3, 45, n).astype(np.int32)        # -1 and >= n_seg: skipped
    b = rng.integers(-5, 520, (3, n)).astype(np.int32)     # out-of-range buckets: skipped
    good = rng.uniform(size=(3, n)) < 0.5                  # NaN / masked samples
    pair(seg, b, good, 40, 512)
    empty = np.where((seg >= 3) & (seg <= 10), 11, seg).astype(np.int32)
    pair(empty, b, good, 40, 512)                          # empty segments
    pair(seg, np.full((3, n), 77, np.int32), np.ones((3, n), bool), 40, 512)   # one bucket
    pair(rng.integers(0, 64, n).astype(np.int32), rng.integers(0, 512, (2, n)).astype(np.int32),
         np.ones((2, n), bool), 64, 512)                   # 64 rings: a 128 KB table
    pair(seg[:4001], b[:1, :4001], good[:1, :4001], 40, 512)   # one frame, N % 4 == 1
    try:
        seghist.segment_histogram_cuda(*(torch.as_tensor(a, device=dev)
                                         for a in (seg, b, good)), 128, 512)
        fail("a 128 x 512 table (256 KB) did not raise")
    except KernelError:
        pass
    print("phase 2c segment_hist adversarial (invalid and out-of-range samples, empty "
          "segments, one bucket, 64 x 512, N % 4 != 0 on 3 frames and on 1, a 256 KB table "
          "refused): kernel == plain", flush=True)

    nf, ns, nb = HIST_MAIN
    seg_t, S, cases = hist_cases(dev, rng, img0)
    nbytes = ns * 4 + nf * ns * 5 + nf * S * nb * 4
    bound = nbytes / PEAK_BYTES * 1e3
    for what, b_t, good_t in cases:
        got = seghist.segment_histogram_cuda(seg_t, b_t, good_t, S, nb)
        torch.cuda.synchronize()
        check(torch.equal(got, seghist.segment_histogram_plain(seg_t, b_t, good_t, S, nb)),
              f"segment_hist {what}: kernel != plain")
        ok = good_t & (seg_t >= 0)[None]
        flat = ((torch.arange(nf, device=dev)[:, None] * S + seg_t.long()[None]) * nb
                + b_t.long())[ok]
        ms = cuda_ms(lambda: seghist.segment_histogram_cuda(seg_t, b_t, good_t, S, nb))
        plain_ms = cuda_ms(lambda: seghist.segment_histogram_plain(seg_t, b_t, good_t, S, nb))
        lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=nf * S * nb))
        print(f"phase 2c segment_hist {what} ({nf} frames, {ns} samples, {S} x {nb}; "
              f"{100 * flat.numel() / (nf * ns):.1f}% of samples counted, "
              f"{int((got > 0).sum())} cells occupied): kernel == plain; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bincount {lib_ms:.3f} ms, bound {bound:.4f} ms by bytes "
              f"({nbytes / 1e6:.1f} MB) ({card})", flush=True)
        if what == "main shape":
            result["segment_hist"].update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound, bound_by="bytes", library_ms=lib_ms)


# --- phase 2d: flux-only stamp extraction --------------------------------------

def stamp_case(rng, T, H, W, N, h):
    """N h x h stamps on a (T, H, W) cube with NaN pixels, a row of +inf and
    a column of -inf: the first stamp flush with the bottom and right edges,
    the second running past both, the third an all-false mask, the fourth
    with every in-mask pixel NaN in cadence 5."""
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[rng.uniform(size=imgs.shape) < 0.01] = np.nan
    imgs[1, H // 2, :] = np.inf
    imgs[2 % T, :, W // 3] = -np.inf
    r0s = rng.integers(0, H - h + 1, N).astype(np.int32)
    c0s = rng.integers(0, W - h + 1, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, h)) < 0.5
    r0s[0], c0s[0] = H - h, W - h
    if N > 1:
        r0s[1], c0s[1] = H - 3, W - 2
        masks[1, :3, :2] = True
    if N > 2:
        masks[2] = False
    if N > 3:
        masks[3] = False
        masks[3, 0, 0] = True
        imgs[5, r0s[3], c0s[3]] = np.nan
    return imgs, masks, r0s, c0s


def stamp_crowded_case(rng, T, H, W, N, h):
    """N h x h stamps on a (T, H, W) cube with NaN pixels, their corners a
    few pixels apart so that neighbours' masks share 32-byte sectors, handed
    over in reverse frame order (the kernel's wrapper sorts them)."""
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[rng.uniform(size=imgs.shape) < 0.01] = np.nan
    r0s = rng.integers(0, min(H - h, 12) + 1, N).astype(np.int32)
    c0s = rng.integers(0, min(W - h, 24) + 1, N).astype(np.int32)
    order = np.argsort(r0s.astype(np.int64) * W + c0s)[::-1]
    masks = rng.uniform(size=(N, h, h)) < 0.3
    return imgs, masks[order], r0s[order], c0s[order]


def stamp_err(got, want, what):
    """Max |got - want| of (N, T) stamp fluxes; fails on another NaN pattern
    or outside RTOL/ATOL."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    check(a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}")
    check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN pattern differs")
    fin = ~np.isnan(b)
    d = np.abs(a[fin] - b[fin])
    if not np.all(d <= ATOL + RTOL * np.abs(b[fin])):
        fail(f"{what}: off by up to {d.max():.3g}")
    return float(d.max()) if d.size else 0.0


def stamp_adversarial(dev, rng):
    """Phase 2d's adversarial inputs: the stamp kernel against its plain
    version, and the domain errors."""
    import torch
    from photometry_tpu_torch.ops import stamp_flux as sf
    from photometry_tpu_torch.ops._kernels import KernelError
    worst = 0.0
    cases = [(8, 40, 256, 1, 1), (8, 64, 256, 7, 17), (512, 64, 256, 9, 17),
             (8, 64, 384, 9, 33), (512, 96, 384, 9, 64), (8, 96, 256, 7, 64)]
    for T_, H_, W_, N, h in cases:
        args = [torch.as_tensor(a, device=dev) for a in stamp_case(rng, T_, H_, W_, N, h)]
        got = sf.stamp_extract_flux(*args, h, h)
        torch.cuda.synchronize()
        worst = max(worst, stamp_err(got, sf.stamp_flux_plain(*args),
                                     f"stamp_flux T={T_} N={N} {h}x{h}"))
        if N > 3:
            g = got.cpu().numpy()
            check(np.isnan(g[2]).all() and np.isnan(g[3, 5]), "empty mask / all-NaN cadence")
    # Planes that do not start on 16 bytes (the kernel reads single pixels
    # then), T not a multiple of the kernel's cadence block, and crowded
    # targets in reverse frame order, through stamp_flux_cuda:
    imgs, masks, r0s, c0s = (torch.as_tensor(a, device=dev)
                             for a in stamp_case(rng, 37, 64, 256, 9, 17))
    flat = torch.empty(imgs.numel() + 1, device=dev)
    shifted = flat[1:].view(imgs.shape)
    shifted.copy_(imgs)
    odd = [torch.as_tensor(a, device=dev) for a in stamp_case(rng, 8, 41, 259, 7, 17)]
    crowd = [torch.as_tensor(a, device=dev) for a in stamp_crowded_case(rng, 37, 48, 96, 40, 17)]
    for what, args in (("T = 37", (imgs, masks, r0s, c0s)), ("planes one float off 16 bytes",
                                                            (shifted, masks, r0s, c0s)),
                       ("41 x 259 planes", odd), ("crowded, reverse frame order", crowd)):
        got = sf.stamp_flux_cuda(*args)
        again = sf.stamp_flux_cuda(*args)
        torch.cuda.synchronize()
        check(bit_equal(got, again), f"stamp_flux {what}: two runs differ")
        worst = max(worst, stamp_err(got, sf.stamp_flux_plain(*args), f"stamp_flux {what}"))
    del flat, shifted
    imgs, masks, r0s, c0s = (torch.as_tensor(a, device=dev)
                             for a in stamp_case(rng, 16, 64, 256, 4, 17))
    refused = 0
    for what, call, err in (
            ("T = 12", lambda: sf.stamp_extract_flux(imgs[:12], masks, r0s, c0s, 17, 17),
             ValueError),
            ("window taller than the image",
             lambda: sf.stamp_extract_flux(imgs[:, :20], masks, r0s * 0, c0s, 17, 17), ValueError),
            ("window wider than the image",
             lambda: sf.stamp_extract_flux(imgs[:, :, :140], masks, r0s, c0s * 0, 17, 17),
             ValueError),
            ("a negative corner",
             lambda: sf.stamp_extract_flux(imgs, masks, r0s - 100, c0s, 17, 17), ValueError),
            ("a 300x300 mask (360 KB of offsets)",
             lambda: sf.stamp_flux_cuda(imgs, torch.ones(1, 300, 300, dtype=torch.bool,
                                                         device=dev), r0s[:1], c0s[:1]),
             KernelError)):
        try:
            call()
        except err:
            refused += 1
            continue
        fail(f"stamp_flux: {what} did not raise {err.__name__}")
    print(f"phase 2d stamp_flux adversarial (NaN and ±inf pixels, an all-NaN cadence, an empty "
          f"mask, stamps flush with and past the edges; N = 1, 7, 9, 40; masks 1, 17, 33, 64 "
          f"px; T = 8, 37, 512; planes off 16 bytes, 41 x 259 planes; crowded targets in "
          f"reverse frame order, two runs bit-equal): kernel == plain (max |diff| "
          f"{worst:.3g}); {refused} domain errors raised", flush=True)
    return worst


def stamp_launcher(images, masks, r0s, c0s, lib=None):
    """A zero-argument launch of the stamp kernel (or of ``lib``, a library
    with its entry point) straight to the library, its arguments prepared
    once (no wrapper, no launch count), and the (N, T) output it writes:
    for timing the kernel alone, on the targets in the order given."""
    import torch
    from photometry_tpu_torch.ops._kernels import STAMP_FLUX
    T_, H_, W_ = images.shape
    N, h, w = masks.shape
    args = (masks.to(torch.uint8).contiguous(), r0s.contiguous(), c0s.contiguous(),
            torch.empty(N, T_, device=images.device))      # alive as long as the launcher
    lib = lib or STAMP_FLUX.lib()
    stream = torch.cuda.current_stream(images.device).cuda_stream

    def launch():
        check(lib.stamp_flux(images.data_ptr(), *(x.data_ptr() for x in args), N, T_, H_, W_, h,
                             w, stream) == 0, "stamp_flux launch")
    return launch, args[-1]


def stamp_windows(results, rows, cols, H, W, h=17):
    """One h x h window per target, centred on its catalog position and kept
    inside the frame, with its K2P2 mask (``TargetResult.mask`` placed at
    ``.stamp``) cut to the window; targets without a mask get the central
    3x3 pixels."""
    N = len(results)
    masks = np.zeros((N, h, h), bool)
    r0s = np.clip(np.rint(rows[:N]).astype(np.int64) - h // 2, 0, H - h).astype(np.int32)
    c0s = np.clip(np.rint(cols[:N]).astype(np.int64) - h // 2, 0, W - h).astype(np.int32)
    for i, r in enumerate(results):
        if r.mask is None:
            masks[i, h // 2 - 1:h // 2 + 2, h // 2 - 1:h // 2 + 2] = True
            continue
        s0, _, s2, _ = r.stamp
        a0, a1 = max(r0s[i], s0), min(r0s[i] + h, s0 + r.mask.shape[0])
        b0, b1 = max(c0s[i], s2), min(c0s[i] + h, s2 + r.mask.shape[1])
        if a1 > a0 and b1 > b0:
            masks[i, a0 - r0s[i]:a1 - r0s[i], b0 - c0s[i]:b1 - c0s[i]] = \
                r.mask[a0 - s0:a1 - s0, b0 - s2:b1 - s2]
    return masks, r0s, c0s


def stamp_main(dev, cube, results, rows, cols, card, result, adv_err, h=17):
    """Phase 2d's main shape: the phase-3 cube and targets through
    ``stamp_extract_flux``, held against the plain version and against the
    band kernel's flux and finite-count sums."""
    import torch
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops import stamp_flux as sf
    from photometry_tpu_torch.ops._kernels import STAMP_FLUX
    images = cube[0]
    T_, H_, W_ = images.shape
    masks, r0s, c0s = stamp_windows(results, rows, cols, H_, W_, h)
    m_t, r_t, c_t = (torch.as_tensor(a, device=dev) for a in (masks, r0s, c0s))
    torch.cuda.synchronize()
    reset_counts()
    got = sf.stamp_extract_flux(images, m_t, r_t, c_t, h, h)
    torch.cuda.synchronize()
    launches = result["stamp_flux"]["launches"] = STAMP_FLUX.launches
    check(launches > 0, "stamp_extract_flux did not launch the stamp kernel")
    err = stamp_err(got, sf.stamp_flux_plain(images, m_t, r_t, c_t), "stamp_flux main shape")
    Q = bandext.band_sums(*cube, m_t, r_t, c_t)
    band = torch.where(Q[:, 1] < 0.5, torch.nan, Q[:, 0])
    band_err = stamp_err(got, band, "stamp_flux vs band_extract flux")
    check(bit_equal(got, sf.stamp_extract_flux(images, m_t, r_t, c_t, h, h)),
          "stamp_flux main shape: two runs differ")
    n_nan = int(torch.isnan(got).sum())
    ms = cuda_ms(lambda: sf.stamp_flux_cuda(images, m_t, r_t, c_t))
    order = bandext._frame_order(r_t, c_t, W_)
    launch, _ = stamp_launcher(images, m_t[order], r_t[order], c_t[order])
    alone = cuda_ms(launch)
    plain_ms = cuda_ms(lambda: sf.stamp_flux_plain(images, m_t, r_t, c_t), reps=3)
    N = len(results)
    npix = int(masks.sum())
    nbytes = stamp_bytes(masks, T_)
    bound = nbytes / PEAK_BYTES * 1e3
    sbytes = stamp_sector_bytes(masks, r0s, c0s, T_, W_, H_)
    sector = sbytes / PEAK_BYTES * 1e3
    gbytes = stamp_sector_bytes(masks, r0s, c0s, T_, W_, H_, sector=64)
    segment = gbytes / PEAK_BYTES * 1e3
    print(f"phase 2d stamp_flux main shape ({T_}, {H_}, {W_}), {N} targets, one {h}x{h} window "
          f"each with its K2P2 mask cut to it ({npix} mask pixels, {npix / N:.1f} per target): "
          f"kernel == plain (max |diff| {err:.3g}) and == band_extract flux where n_fin > 0 "
          f"(max |diff| {band_err:.3g}), two runs bit-equal; {n_nan} NaN outputs; kernel alone "
          f"{alone:.3f} ms (frame order), stamp_flux_cuda {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"bound {bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB, kernel at "
          f"{100 * bound / alone:.0f}%), {sector:.4f} ms by 32-byte sectors ({sbytes / 1e6:.1f} "
          f"MB, the union over targets; kernel at {100 * sector / alone:.0f}%), {segment:.4f} ms "
          f"by 64-byte segments ({gbytes / 1e6:.1f} MB; kernel at {100 * segment / alone:.0f}%); "
          f"launches "
          f"{launches}; no single torch call computes this masked NaN-aware window sum ({card})",
          flush=True)
    result["stamp_flux"].update(max_abs_err=max(adv_err, err), ms=ms, kernel_ms=alone,
                                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                                sector_bound_ms=sector, segment_bound_ms=segment,
                                library_ms=None)


# --- phase 6: ECC registration against injected motion -------------------------

def ecc_phase(dev, img0, gen, rng, ctx_kw, sids, card, n_frames=32, n_targets=1024):
    """Phase 6: ``n_frames`` copies of the star field ``img0`` shifted by a
    known drift plus jitter (an FFT phase ramp, on the card) with fresh
    noise, registered by ``MotionModel.calc_kernels_batch``; the recovered
    series then drives the aperture slice's jitter (``pos_corr``)."""
    import torch
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.core.motion import MotionModel, ecc_sub_batch
    from photometry_tpu_torch.core.status import STATUS
    H_, W_ = img0.shape
    k = np.arange(n_frames) / (n_frames - 1)
    shifts = np.stack([-0.6 + 1.2 * k, 0.5 - 0.9 * k], 1) + rng.normal(0, 0.25, (n_frames, 2))
    shifts = np.clip(shifts, -1.5, 1.5)
    shifts[0] = 0.0                                    # frame 0 is the reference
    spec = torch.fft.rfft2(torch.as_tensor(img0, device=dev))
    ky = torch.fft.fftfreq(H_, device=dev)[:, None]
    kx = torch.fft.rfftfreq(W_, device=dev)[None, :]
    frames = torch.empty(n_frames, H_, W_, device=dev)
    for i, (dx, dy) in enumerate(shifts):
        ramp = torch.exp(-2j * np.pi * (kx * float(dx) + ky * float(dy)))
        f = torch.fft.irfft2(spec * ramp, s=(H_, W_))
        frames[i] = f + torch.sqrt(torch.clamp(f, min=0.0) + 25.0) * torch.randn(
            H_, W_, device=dev, generator=gen)
    del spec, ramp, f
    mm = MotionModel("translation", image_ref=frames[0])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    kern = mm.calc_kernels_batch(frames, device=dev)
    wall = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated() - base
    err = np.abs(kern - shifts)
    print(f"phase 6 ECC: {n_frames} frames of {H_}x{W_} shifted by up to "
          f"{np.abs(shifts).max():.2f} px, translation kernels in {wall:.2f} s = "
          f"{n_frames / wall:.1f} frames/s (sub-batch "
          f"{min(n_frames, ecc_sub_batch(H_, W_, 'translation'))} frames, peak "
          f"{peak / 1e9:.2f} GB above the {base / 1e9:.1f} GB held); |recovered - injected| "
          f"median {np.median(err):.4f} px, max {err.max():.4f} px (frame "
          f"{np.unravel_index(err.argmax(), err.shape)[0]}) ({card})", flush=True)
    check(err.max() < 0.05, f"ECC misses the injected shifts by up to {err.max():.3f} px")

    tt = np.asarray(ctx_kw["time"], np.float64) - np.asarray(ctx_kw["timecorr"], np.float64)
    idx = np.rint(np.linspace(0, len(tt) - 1, n_frames)).astype(int)
    series = MotionModel("translation")
    series.load_series(tt[idx], kern)
    ctx = SectorContext.from_arrays(**ctx_kw, motion=series)
    try:
        res = extract_aperture_batch(ctx, sids[:n_targets])
    finally:
        ctx.close()
    want = np.stack([np.interp(tt, tt[idx], kern[:, c]) for c in range(2)], -1)
    good = [r for r in res if r.status in (STATUS.OK, STATUS.WARNING)]
    check(len(good) >= 0.9 * n_targets, "phase 6: fewer than 90% of targets OK or WARNING")
    dev_pc = max(float(np.abs(r.lightcurve["pos_corr"] - want).max()) for r in good)
    print(f"phase 6 jitter: {len(good)} of {n_targets} targets' per-cadence pos_corr follow the "
          f"loaded kernel series (max |diff| {dev_pc:.2e} px over {len(tt)} cadences)", flush=True)
    check(dev_pc < 1e-5, "pos_corr does not follow the loaded movement kernels")


# --- phase 7: the default-method drain -------------------------------------------

def phase7_layout(rng, rows, cols, tmag, H_, W_):
    """Positions and magnitudes of phase 7's injected stars.

    Bright stars (Tmag 3.5-6.0) take the engine's two halo routes.  The
    first half sit 1-2 px inside the left or right CCD edge ("edge": the
    stamp cannot grow past the CCD, "Stamp resize hit limit").  The second
    half (Tmag 3.5-4.5, all saturated) carry a faint charge tail
    ``P7["tail"]`` rows up their column ("tail": the mask follows it past
    ten resizes, "Too many stamp resizes."); each sits where no catalog
    star lies within 4 columns of that corridor, whose watershed basin
    would cut the tail off the target's mask.  The pairs are tests/test_deblend_switch.py's:
    separations 3.5-6.0 px along (0.7, 0.714), Tmag 10.0 and 10.3, each at
    a spot with no field star within 7 px and away from the bright stars.
    Returns a dict of arrays."""
    n_bright, n_pairs, tail = P7["bright"], P7["pairs"], P7["tail"]
    n_edge = n_bright // 2
    n_tail = n_bright - n_edge
    span = np.linspace(60, H_ - 60, n_edge)
    b_rows = list(span + rng.uniform(-5, 5, n_edge))
    b_cols = list(np.where(np.arange(n_edge) % 2 == 0, rng.uniform(1.0, 2.0, n_edge),
                           W_ - 1 - rng.uniform(1.0, 2.0, n_edge)))
    for _ in range(200000):
        if len(b_rows) == n_bright:
            break
        r, c = rng.uniform(40, H_ - tail - 40), rng.uniform(60, W_ - 60)
        in_corridor = (np.abs(cols - c) <= 4) & (rows > r - 10) & (rows < r + tail + 10)
        if in_corridor.any() or any(abs(c - c2) < 30 and abs(r - r2) < tail + 40
                                    for r2, c2 in zip(b_rows[n_edge:], b_cols[n_edge:])):
            continue
        b_rows.append(r)
        b_cols.append(c)
    check(len(b_rows) == n_bright, f"phase 7: room for {len(b_rows) - n_edge} of {n_tail} "
          "tail corridors")
    b_rows, b_cols = np.array(b_rows), np.array(b_cols)
    b_tmag = np.concatenate([rng.uniform(3.5, 6.0, n_edge), rng.uniform(3.5, 4.5, n_tail)])
    route = np.array(["edge"] * n_edge + ["tail"] * n_tail)

    pairs = []
    seps = np.linspace(3.5, 6.0, n_pairs)
    for _ in range(100000):
        if len(pairs) == n_pairs:
            break
        r, c = rng.uniform(30, H_ - 40), rng.uniform(30, W_ - 40)
        sep = seps[len(pairs)]
        r2, c2 = r + sep * 0.7, c + sep * 0.714
        if (np.min(np.hypot(rows - r, cols - c)) < 7 or np.min(np.hypot(rows - r2, cols - c2)) < 7
                or np.any((np.abs(b_cols - c) < 40) & (r > b_rows - 40)
                          & (r < b_rows + tail + 40))
                or any(np.hypot(r - p[0], c - p[1]) < 20 for p in pairs)):
            continue
        pairs.append((r, c, r2, c2))
    check(len(pairs) == n_pairs, f"phase 7: room for {len(pairs)} of {n_pairs} pairs")
    p = np.array(pairs)
    return {"b_rows": b_rows, "b_cols": b_cols, "b_tmag": b_tmag, "route": route,
            "p_rows": np.stack([p[:, 0], p[:, 2]], 1).ravel(),
            "p_cols": np.stack([p[:, 1], p[:, 3]], 1).ravel(),
            "p_tmag": np.tile([10.0, 10.3], n_pairs)}


def psf_window(r, c, win, H_, W_, integrated=False, wing=0.0, reach=7):
    """Rows and columns of a star's window, clipped to the frame, and its
    unit-flux PSF there: a Gaussian core of sigma 1.2 px, point-sampled
    within 7 px as make_field's or ``integrated`` over each pixel as the
    context PRF, plus a ``wing`` share of the flux in a Moffat halo (core
    radius 2 px, beta 1.5) out to ``reach`` px, the extended wings a TESS
    PSF has around bright stars."""
    from scipy.special import erf
    ri, ci = int(r), int(c)
    r0, r1 = max(ri - max(win, reach), 0), min(ri + max(win, reach) + 1, H_)
    c0, c1 = max(ci - reach, 0), min(ci + reach + 1, W_)
    yy, xx = np.mgrid[r0:r1, c0:c1]
    if integrated:
        d = np.sqrt(2.0) * 1.2
        psf = 0.25 * ((erf((yy - r + 0.5) / d) - erf((yy - r - 0.5) / d))
                      * (erf((xx - c + 0.5) / d) - erf((xx - c - 0.5) / d)))
    else:
        psf = np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / 1.2 ** 2) / (2 * np.pi * 1.2 ** 2)
    psf[(np.abs(yy - ri) > 7) | (np.abs(xx - ci) > 7)] = 0.0
    if wing:
        d2 = (yy - r) ** 2 + (xx - c) ** 2
        moffat = 0.5 / (np.pi * 4.0) * (1 + d2 / 4.0) ** -1.5
        psf = (1 - wing) * psf + wing * np.where(d2 <= reach ** 2, moffat, 0.0)
    return r0, r1, c0, c1, psf


def renoise_phase7(images, errs, img0, gen, sky=100.0, exptime=1425.6):
    """Redraw the cubes' noise at a TESS-like level, in place: the field
    ``img0`` plus Gaussian noise of variance (flux + sky) / exptime per
    cadence (the simulator's SimConfig bkg_level and exptime_eff).  The
    halo's per-pixel median normalisation divides by pixel medians near 0,
    which the e-/s-as-counts noise of the earlier phases swamps."""
    import torch
    base = torch.as_tensor(img0, device=images.device)
    sigma = torch.sqrt((torch.clamp(base, min=0.0) + sky) / exptime)
    errs[:] = sigma
    for t0 in range(0, images.shape[0], 64):
        n = min(64, images.shape[0] - t0)
        images[t0:t0 + n] = base + sigma * torch.randn(n, *base.shape, device=images.device,
                                                       generator=gen)


def inject_phase7(images, errs, lay, gen, exptime=1425.6):
    """Add phase 7's stars to the (T, H, W) cubes on their device.

    Bright stars vary by a 1% sinusoid (two periods over the T cadences,
    a random phase each) and hold 5% of their flux in extended wings out
    to 40 px (``psf_window``).  Each cadence's core is clipped at
    SATURATION_FLUX and the clipped charge of each column is spread along
    that column, flux conserved: filled to saturation outward from the core
    (a bleed), and for the "tail" stars 30% of it evenly over the column's
    unsaturated pixels up to ``P7["tail"]`` rows above the star (a faint
    charge tail).  Pairs
    are constant, with the pixel-integrated PSF of the context's PRF.
    Every injected pixel gets photon noise (variance flux / exptime) and
    its error grows to match.  Returns the bright stars' (N, T)
    modulations and the injected mean flux of every star."""
    import torch
    from photometry_tpu_torch.models.halo import SATURATION_FLUX as S
    from photometry_tpu_torch.utils.mathutils import mag2flux
    T_, H_, W_ = images.shape
    tail = P7["tail"]
    dev = images.device
    tt = torch.arange(T_, device=dev, dtype=torch.float32)
    nb = len(lay["b_tmag"])
    phases = torch.rand(nb, generator=gen, device=dev) * 2 * np.pi
    mods = 1.0 + 0.01 * torch.sin(4 * np.pi * tt[None] / T_ + phases[:, None])    # (nb, T)
    means = []
    stars = [(lay["b_rows"][i], lay["b_cols"][i], lay["b_tmag"][i], mods[i], lay["route"][i])
             for i in range(nb)]
    stars += [(r, c, m, None, "pair") for r, c, m in zip(lay["p_rows"], lay["p_cols"],
                                                           lay["p_tmag"])]
    for r, c, m, mod, route in stars:
        win = 7 if route == "pair" else 40 if route == "edge" else tail + 10
        r0, r1, c0, c1, psf = psf_window(r, c, win, H_, W_, integrated=route == "pair",
                                         wing=0.0 if route == "pair" else 0.05,
                                         reach=7 if route == "pair" else 40)
        f = float(mag2flux(m))
        psf_d = torch.as_tensor(psf, dtype=torch.float32, device=dev)
        star = f * psf_d[None] * (mod[:, None, None] if mod is not None else 1.0)   # (T, h, w)
        if route != "pair":
            core = torch.clamp(star, max=S)
            excess = (star - core).sum(dim=1)                               # (T, w)
            if route == "tail":
                tail_e, excess = 0.3 * excess, 0.7 * excess
            # Fill outward from the star's row, alternating down and up:
            k = torch.arange(r1 - r0, device=dev) + r0 - int(r)
            order = torch.argsort(torch.abs(k) * 2 + (k < 0), stable=True)
            cap = (S - core)[:, order]                                      # (T, h, w)
            before = torch.cumsum(cap, dim=1) - cap
            fill = torch.minimum(torch.clamp(excess[:, None, :] - before, min=0.0), cap)
            core[:, order] += fill
            if route == "tail":
                wgt = ((core < 0.5 * S) & ((k > 0) & (k <= tail))[None, :, None]).float()
                core += tail_e[:, None, :] * wgt / torch.clamp(wgt.sum(dim=1, keepdim=True),
                                                              min=1.0)
            star = core
        noise = torch.sqrt(torch.clamp(star, min=0.0) / exptime) * torch.randn(
            star.shape, device=dev, generator=gen)
        images[:, r0:r1, c0:c1] += star + noise
        errs[:, r0:r1, c0:c1] = torch.sqrt(errs[:, r0:r1, c0:c1] ** 2
                                           + torch.clamp(star, min=0) / exptime)
        means.append(float(star.sum(dim=(1, 2)).mean()))
    return mods.cpu().numpy(), np.array(means)


def write_todo(folder, sids, tmags, camera=1, ccd=1, datasources=None, cadences=None):
    """todo.sqlite in the todolist schema (photometry_tpu/todolist.py:279-291),
    every task with no method, priorities by Tmag; FFI targets at 1,800 s
    unless ``datasources`` and ``cadences`` say otherwise, task by task."""
    import sqlite3
    n = len(sids)
    datasources = ["ffi"] * n if datasources is None else list(datasources)
    cadences = [1800] * n if cadences is None else list(cadences)
    order = np.argsort(tmags, kind="stable")
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        conn.execute("""CREATE TABLE todolist (
            priority INTEGER PRIMARY KEY ASC NOT NULL, starid INTEGER NOT NULL,
            sector INTEGER NOT NULL, datasource TEXT NOT NULL DEFAULT 'ffi',
            camera INTEGER NOT NULL, ccd INTEGER NOT NULL, cadence INTEGER NOT NULL,
            method TEXT DEFAULT NULL, tmag REAL, status INTEGER DEFAULT NULL,
            cbv_area INTEGER NOT NULL);""")
        conn.executemany(
            "INSERT INTO todolist (priority, starid, sector, camera, ccd, cadence, datasource, "
            "tmag, cbv_area) VALUES (?, ?, 1, ?, ?, ?, ?, ?, ?);",
            [(p + 1, int(sids[i]), camera, ccd, int(cadences[i]), datasources[i],
              float(tmags[i]), camera * 100 + ccd * 10 + 1) for p, i in enumerate(order)])
        conn.execute("CREATE UNIQUE INDEX unique_target_idx ON todolist "
                     "(starid, datasource, sector, camera, ccd, cadence);")
        conn.execute("CREATE INDEX status_idx ON todolist (status);")


def add_tasks(todo, tasks, camera=1, ccd=1):
    """Add (starid, tmag, datasource, cadence) tasks of sector 1 with no
    method to a todo list, and number every row's priority by Tmag again
    (stable), as make_todo numbers them."""
    import sqlite3
    cols = "starid, sector, datasource, camera, ccd, cadence, method, tmag, cbv_area"
    with sqlite3.connect(todo) as conn:
        rows = conn.execute(f"SELECT {cols} FROM todolist ORDER BY priority").fetchall()
        rows += [(sid, 1, ds, camera, ccd, cad, None, tm, camera * 100 + ccd * 10 + 1)
                 for sid, tm, ds, cad in tasks]
        rows.sort(key=lambda r: r[7])
        conn.execute("DELETE FROM todolist")
        conn.executemany(f"INSERT INTO todolist (priority, {cols}) VALUES (?,?,?,?,?,?,?,?,?,?)",
                         [(p + 1,) + tuple(r) for p, r in enumerate(rows)])


def solve_parity(lin_solves, card):
    """The drain's first linPSF solve, its first P7_PARITY targets again on
    a CPU copy of their stamps, positions and PRF: fluxes within rtol 1e-4
    (tests/test_psf_models.py:190) and 1e-4 of each star's median |flux|
    (the card test's atol)."""
    from photometry_tpu_torch.models import linpsf
    from photometry_tpu_torch.models.prf import PRF
    check(len(lin_solves) == 1, "phase 7: no linPSF solve was recorded")
    (ins, prf, shape, S, got), = lin_solves
    prf_cpu = PRF(prf.iprf, prf.oversample, prf.center_x, prf.center_y, info=dict(prf.info),
                  device="cpu")
    want = linpsf.linpsf_timeseries_batch(*(x.cpu() for x in ins), prf_cpu, shape, S)["fluxes"]
    got, want = got.cpu().double().numpy(), want.double().numpy()           # (k, T, S)
    atol = 1e-4 * np.median(np.abs(want), axis=1, keepdims=True)
    d = np.abs(got - want)
    rel = float(np.max(d / (atol + 1e-4 * np.abs(want) + 1e-300)))
    print(f"phase 7 linPSF parity: the first solve's {got.shape[0]} targets x {got.shape[1]} "
          f"cadences x S={S} (stamps {shape[0]}x{shape[1]}) on the card == a CPU re-run: max "
          f"|diff| {d.max():.3g}, {rel:.3f} of the rtol 1e-4 bound ({card})", flush=True)
    check(bool(np.all(d <= atol + 1e-4 * np.abs(want))),
          f"phase 7: linPSF fluxes on the card differ from the CPU by up to {d.max():.3g}")


def tvmin_parity(tv_runs, card):
    """The halo flush's first TV-min descent, its P7_PARITY targets with the
    most pixels again on a CPU copy of their normalised fluxes: weights within rtol
    5e-4, atol 1e-6, objectives within rel 1e-3 (tests/test_halo.py:62-66);
    masked pixels weigh exactly 0 and each row sums to 1."""
    import torch
    from photometry_tpu_torch.models import halo
    check(len(tv_runs) == 1, "phase 7: no TV-min descent was recorded")
    (ins, kw, w_got, v_got), = tv_runs
    fn, gt, ok = (x.cpu() for x in ins)
    w_want, v_want = halo.tvmin_weights_batch(fn, gt, ok, **kw)
    w_got, v_got = w_got.cpu().double(), v_got.cpu().double()
    w_want, v_want = w_want.double(), v_want.double()
    dw = (w_got - w_want).abs()
    dv = float(((v_got - v_want).abs() / v_want.abs()).max())
    sums = float((w_got.sum(dim=-1) - 1.0).abs().max())
    print(f"phase 7 TV-min parity: the flush's first descent, its {fn.shape[0]} largest "
          f"targets x {fn.shape[1]} cadences x {ok.sum(dim=-1).tolist()} pixels ({kw}), of "
          f"{fn.shape[2]} padded, on the card == "
          f"a CPU re-run: weights max |diff| {float(dw.max()):.3g}, objective rel "
          f"{dv:.3g}; masked weights 0, rows sum to 1 within {sums:.2g} ({card})", flush=True)
    check(bool((dw <= 1e-6 + 5e-4 * w_want.abs()).all()),
          f"phase 7: TV-min weights on the card differ from the CPU by up to {float(dw.max()):.3g}")
    check(dv <= 1e-3, f"phase 7: TV-min objective on the card differs from the CPU by {dv:.3g}")
    check(bool(torch.all(w_got[~ok] == 0)) and sums < 1e-5,
          "phase 7: TV-min weights leak onto masked pixels or do not sum to 1")


def drain_phase(work, dev, gen, rng, cubes, img0, rows, cols, tmag, wcs, card):
    """Phase 7: the default-method drain at full CCD size (see the module docstring)."""
    import sqlite3
    import torch
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    from photometry_tpu_torch.core.engine import SectorContext
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.models import halo, linpsf
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    images, errs, bkgs, flags = cubes
    T_, H_, W_ = images.shape
    tic = time.perf_counter()
    lay = phase7_layout(rng, rows, cols, tmag, H_, W_)
    renoise_phase7(images, errs, img0, gen)
    mods, injected = inject_phase7(images, errs, lay, gen)
    nb, npair = len(lay["b_tmag"]), len(lay["p_tmag"])
    n0 = len(rows)
    all_rows = np.concatenate([rows, lay["b_rows"], lay["p_rows"]])
    all_cols = np.concatenate([cols, lay["b_cols"], lay["p_cols"]])
    all_tmag = np.concatenate([tmag, lay["b_tmag"], lay["p_tmag"]])
    sids = np.arange(1, len(all_rows) + 1)
    b_sids, p_sids = sids[n0:n0 + nb], sids[n0 + nb:]
    folder = os.path.join(work, "phase7")
    os.makedirs(folder)
    ra, dec = wcs.radec_of_rowcol(all_rows, all_cols)
    cat = make_catalog_from_arrays(folder, 1, 1, 1, starid=sids, ra_j2000=ra, dec_j2000=dec,
                                   pm_ra=np.zeros(len(sids)), pm_dec=np.zeros(len(sids)),
                                   tmag=all_tmag, reference_time=2458340.0)
    ctx_kw = dict(images=images, images_err=errs, backgrounds=bkgs, pixelflags=flags,
                  sumimage=torch.nanmean(images, dim=0).cpu().numpy(),
                  time=1325.3 + np.arange(T_) / 48.0, timecorr=np.zeros(T_, np.float32),
                  cadenceno=np.arange(T_, dtype=np.int32), quality=np.zeros(T_, np.int32),
                  catalog_path=cat, wcs=wcs, sector=1, camera=1, ccd=1,
                  header={"PSFSIGMA": 1.2}, input_folder=folder, device=dev)
    field = [int(s) for s in np.argsort(tmag, kind="stable")[:P7["todo"] - nb - npair] + 1]
    todo = [int(s) for s in b_sids] + [int(s) for s in p_sids] + field
    write_todo(folder, todo, all_tmag[np.array(todo) - 1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"phase 7 inputs: {nb} bright stars (Tmag {lay['b_tmag'].min():.2f}-"
          f"{lay['b_tmag'].max():.2f}, {np.sum(lay['route'] == 'edge')} on the CCD's edges, "
          f"{np.sum(lay['route'] == 'tail')} with {P7['tail']}-row charge tails), "
          f"{npair // 2} pairs at 3.5-6.0 px, injected into the ({T_}, {H_}, {W_}) cubes on "
          f"the card; todo.sqlite of {len(todo)} tasks, method NULL "
          f"({time.perf_counter() - tic:.1f} s)",
          flush=True)

    # Observers of the drain's own calls (each passes through unchanged):
    aperture, flushes, lin_calls = {}, [], []
    band_calls, lin_solves, tv_runs = [], [], []
    run_aperture, flush, run_linpsf = (dispatcher.extract_aperture_batch,
                                       dispatcher.HaloSwitchQueue.flush,
                                       linpsf.extract_linpsf_batch)
    run_band, run_solve, run_tvmin = (bandext.band_sums, linpsf.linpsf_timeseries_batch,
                                      halo.tvmin_weights_batch)

    def seen_aperture(ctx_, starids, **kw):
        out = run_aperture(ctx_, starids, **kw)
        aperture.update({r.starid: r for r in out})
        return out

    def seen_band(*a, **kw):
        """Each lease's band launch: its arguments and the sums it returned."""
        out = run_band(*a, **kw)
        band_calls.append((a, kw, out))
        return out

    def seen_solve(imgs, rows_t, cols_t, valid, prf, shape, S):
        """The first linPSF solve's inputs and fluxes, for its first P7_PARITY targets."""
        out = run_solve(imgs, rows_t, cols_t, valid, prf, shape, S)
        if not lin_solves:
            k = P7_PARITY
            lin_solves.append(([x[:k].clone() for x in (imgs, rows_t, cols_t, valid)],
                               prf, shape, S, out["fluxes"][:k].clone()))
        return out

    def seen_tvmin(flux_norm, good_time, pixel_ok, **kw):
        """The first TV-min descent's inputs and weights, for the P7_PARITY
        targets with the most pixels."""
        w, val = run_tvmin(flux_norm, good_time, pixel_ok, **kw)
        if not tv_runs:
            ok = torch.as_tensor(pixel_ok)
            k = torch.argsort(ok.sum(dim=-1), descending=True, stable=True)[:P7_PARITY]
            tv_runs.append(([torch.as_tensor(x)[k].clone()
                             for x in (flux_norm, good_time, pixel_ok)], kw,
                            w[k].clone(), val[k].clone()))
        return w, val

    def seen_flush(self, force=False):
        tic_ = time.perf_counter()
        out = flush(self, force)
        if out:
            flushes.append((len(out), time.perf_counter() - tic_, out))
        return out

    def seen_linpsf(ctx_, starids, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        tic_ = time.perf_counter()
        out = run_linpsf(ctx_, starids, **kw)
        peak = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        lin_calls.append((len(starids), time.perf_counter() - tic_, peak))
        return out

    def drain(timers):
        ctx = SectorContext.from_arrays(**ctx_kw)
        with mock.patch.object(dispatcher, "open_context", lambda *a, **k: ctx):
            return run_drain(folder, 1, method=None, batch_size=256, timers=timers, device=dev)

    timers = new_timers()
    reset_counts()
    with mock.patch.object(dispatcher, "extract_aperture_batch", seen_aperture), \
            mock.patch.object(dispatcher.HaloSwitchQueue, "flush", seen_flush), \
            mock.patch.object(linpsf, "extract_linpsf_batch", seen_linpsf), \
            mock.patch.object(bandext, "band_sums", seen_band), \
            mock.patch.object(linpsf, "linpsf_timeseries_batch", seen_solve), \
            mock.patch.object(halo, "tvmin_weights_batch", seen_tvmin):
        n_done = drain(timers)
    band_launches = BAND_EXTRACT.launches
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        status = dict(conn.execute("SELECT starid, status FROM todolist"))
        diag = {sid: (m, e or "", lc) for sid, m, e, lc in conn.execute(
            "SELECT t.starid, d.method_used, d.errors, d.lightcurve FROM todolist t "
            "JOIN diagnostics d ON t.priority = d.priority")}
    final = {STATUS.OK.value, STATUS.WARNING.value, STATUS.ERROR.value, STATUS.SKIPPED.value}
    counts = {s: sum(v == s for v in status.values()) for s in set(status.values())}
    # A task another target's mask claimed before its lease is SKIPPED
    # without being run (TaskManager's arbitration):
    unleased = sum(s not in diag and status[s] == STATUS.SKIPPED.value for s in todo)
    methods = [diag.get(s, ("none",))[0] for s in todo]
    t = timers
    print(f"phase 7 drain: {n_done} tasks in {t['wall']:.2f} s = {n_done / t['wall']:.1f} "
          f"tasks/s with products ({card}); lease {t['lease']:.2f} s, context "
          f"{t['context']:.2f} s, photometry {t['photometry']:.2f} s, save {t['save']:.2f} s "
          f"({t.get('n_products', 0)} products), sqlite {t['sqlite']:.2f} s; "
          f"{t['n_batches']} leases; band kernel launches {band_launches}; statuses "
          + ", ".join(f"{'NULL' if s is None else STATUS(s).name} {c}"
                      for s, c in sorted(counts.items(), key=lambda kv: kv[0] or 0))
          + f" ({unleased} skipped before their lease); methods "
          + ", ".join(f"{m} {methods.count(m)}" for m in sorted(set(methods))), flush=True)
    check(None not in counts and set(counts) <= final,
          f"phase 7: statuses left unfinished: {counts}")
    check(n_done == len(diag) and n_done + unleased == len(todo),
          f"phase 7: the drain returned {n_done}; {len(diag)} tasks have diagnostics, "
          f"{unleased} were skipped unleased, of {len(todo)}")
    check(band_launches > 0, "phase 7: the drain did not launch the band kernel")

    # The band kernel's sums of every lease against the plain ones on that
    # lease's own inputs, and the aperture outputs they give (phase 3's rules):
    band_err, band_targets = 0.0, 0
    for a, kw, got in band_calls:
        args = a[:7]
        windows = a[7] if len(a) > 7 else kw.get("windows")
        want = bandext.band_sums_plain(*args, windows)
        band_err = max(band_err, band_sums_err(got, want, "phase 7 band launch"))
        masks, r0s, c0s = args[4:7]
        size = masks.reshape(masks.shape[0], -1).to(torch.float32).sum(dim=1)
        band_err = max(band_err, max_err(host(bandext._combine(got, r0s, c0s, size)),
                                         host(bandext._combine(want, r0s, c0s, size)),
                                         "phase 7 band launch"))
        band_targets += masks.shape[0]
    ap_good = [r for r in aperture.values() if r.status in (STATUS.OK, STATUS.WARNING)]
    ap_fin = min((float(np.isfinite(r.lightcurve["flux"]).mean()) for r in ap_good),
                 default=0.0)
    print(f"phase 7 band kernel: {band_launches} launches in the drain ({len(band_calls)} "
          f"recorded, {band_targets} targets x {T_} cadences); each lease's sums == plain on "
          f"its own inputs (counts exact, max |diff| {band_err:.3g}); {len(ap_good)} of "
          f"{len(aperture)} aperture results OK or WARNING, finite flux share min "
          f"{ap_fin:.4f}", flush=True)
    check(len(band_calls) == band_launches,
          f"phase 7: {len(band_calls)} band calls recorded, {band_launches} launches counted")
    check(all(r.lightcurve["flux"].shape == (T_,) for r in ap_good) and ap_fin > 0.99,
          "phase 7: an aperture light curve is not finite or has the wrong shape")

    # Bright stars: halo, by both routes, tracking the injected sinusoid.
    halo_res = {int(tk["starid"]): r for _, _, out in flushes for tk, r in out}
    routes = {"Stamp resize hit limit. Haloswitch quick break.": 0,
              "Too many stamp resizes.": 0}
    switched, corr = 0, []
    for i, sid in enumerate(b_sids):
        sid = int(sid)
        for e in (aperture[sid].details.get("errors") or []) if sid in aperture else []:
            if e in routes:
                routes[e] += 1
        m, errors, _ = diag.get(sid, ("none", "", None))
        if m == "halo" and "Automatically switched to Halo photometry" in errors:
            switched += 1
            fl = halo_res[sid].lightcurve["flux"]
            ok = np.isfinite(fl)
            corr.append(float(np.corrcoef(fl[ok] / np.median(fl[ok]), mods[i][ok])[0, 1]))
    n_flush = [n for n, _, _ in flushes]
    print(f"phase 7 halo: {switched} of {nb} bright stars switched to halo (aperture errors: "
          + ", ".join(f"{k!r} {v}" for k, v in routes.items())
          + f"); {len(flushes)} queue flushes of {n_flush} targets in "
          f"{[round(w, 3) for _, w, _ in flushes]} s; light curve vs injected sinusoid: "
          f"correlation min {min(corr, default=np.nan):.3f}, median "
          f"{np.median(corr) if corr else np.nan:.3f} ({card})", flush=True)
    check(switched >= 0.9 * nb, f"phase 7: only {switched} of {nb} bright stars went to halo")
    check(all(v > 0 for v in routes.values()), f"phase 7: a halo route never fired: {routes}")
    check(len(corr) == switched and min(corr) > 0.5,
          f"phase 7: a halo light curve does not follow its sinusoid: {sorted(corr)[:3]}")
    read = 0
    for sid in b_sids[:8]:
        r = halo_res.get(int(sid))
        if r is None or read == 3:
            continue
        hdus = pf.read_fits(r.details["filepath_lightcurve"])
        names = [h.name for h in hdus]
        check("WEIGHTMAP" in names, f"TIC {sid}: no WEIGHTMAP extension in the halo product")
        wm = hdus[names.index("WEIGHTMAP")].data["WEIGHTMAP"]
        check(np.array_equal(np.asarray(wm), r.details["halo_weightmap"]["weightmap"]),
              f"TIC {sid}: WEIGHTMAP differs from the result's weightmap")
        read += 1
    check(read == 3, "phase 7: fewer than 3 halo products read back")
    path = next(r.details["filepath_lightcurve"] for r in halo_res.values()
                if r.details.get("filepath_lightcurve"))
    print(f"phase 7 products: {native_state('7')}; {product_twice('7', path, work)}", flush=True)

    # Pairs: linPSF, recovering the injected flux.
    lin, good = 0, 0
    rel = []
    for j, sid in enumerate(p_sids):
        m, errors, path = diag.get(int(sid), ("none", "", None))
        if m != "linpsf" or "Automatically switched to linPSF photometry" not in errors:
            continue
        lin += 1
        flux = np.asarray(pf.read_fits(os.path.join(folder, path))[1].data["FLUX_RAW"],
                          np.float64)
        truth = injected[nb + j]
        rel.append(abs(np.nanmean(flux) - truth) / truth)
        good += rel[-1] < 0.05
    lin_wall = sum(w for _, w, _ in lin_calls)
    print(f"phase 7 linPSF: {lin} of {npair} pair members switched to linPSF, {good} of them "
          f"within 5% of the injected mean flux (|rel| median {np.median(rel):.4f}, max "
          f"{max(rel):.4f}); {len(lin_calls)} reruns of {[n for n, _, _ in lin_calls]} targets "
          f"in {lin_wall:.2f} s, peak memory {max(p for _, _, p in lin_calls) / 1e9:.2f} GB "
          f"above what was held ({card})", flush=True)
    check(lin >= 0.9 * npair, f"phase 7: only {lin} of {npair} pair members went to linPSF")
    check(good >= 0.9 * lin, f"phase 7: only {good} of {lin} linPSF pairs within 5%")
    solve_parity(lin_solves, card)
    tvmin_parity(tv_runs, card)

    if dev.type == "cuda":
        # The drain's first lease again under torch.profiler, on a fresh todo
        # (the bright stars' lease with its halo flush): the trace of all
        # eight takes minutes to collect and sort.
        n_prof = 256
        os.replace(os.path.join(folder, "todo.sqlite"), os.path.join(folder, "done.sqlite"))
        write_todo(folder, todo[:n_prof], all_tmag[np.array(todo[:n_prof]) - 1])
        ptimers = new_timers()
        tic = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            drain(ptimers)
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        print(f"phase 7 profile ({ptimers['n_done']} tasks, {ptimers['n_batches']} leases): device "
              f"busy {busy:.1f} ms = {100 * busy / (ptimers['photometry'] * 1e3):.2f}% of the "
              f"profiled photometry phase's {ptimers['photometry']:.2f} s (drain "
              f"{ptimers['wall']:.2f} s profiled, {time.perf_counter() - tic:.1f} s with the "
              f"trace's processing); top device ops: {top_device_ops(prof)} ({card})", flush=True)
    return {"wall": t["wall"], "n": n_done, "ctx_kw": ctx_kw, "todo": todo,
            "tmags": all_tmag[np.array(todo) - 1], "folder": folder}


# --- phase 3b: bfloat16 cubes ---------------------------------------------------

def bf16_slice(ctx_kw, sids, results32, prf, card, result):
    """Phase 3b (1 and 2): a bfloat16 context cast on the card from phase 3's
    cube; ``extract_aperture_batch`` on phase 3's targets, its band launch
    recorded and held to plain, statuses and masks equal to phase 3's and
    fluxes against phase 3's float32 ones at tests/test_engine_extras.py's
    sector-scale bounds; then PSF, linPSF and halo forced by ``method``
    through ``photometry_batch``, each on P7_PARITY targets held to a CPU
    re-run on a host copy of the same bfloat16 cube."""
    import torch
    from photometry_tpu_torch.core.dispatcher import photometry_batch
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ctx = SectorContext.from_arrays(**ctx_kw, cube_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - tic
    cubes = (ctx.images, ctx.images_err, ctx.backgrounds)
    check(all(x.dtype == torch.bfloat16 and x.device.type == ctx.device.type for x in cubes),
          "phase 3b: the context's cubes are not bfloat16 on the context's device")
    gb = sum(x.numel() * x.element_size() for x in cubes) / 1e9

    captured, run_band = [], bandext.band_sums

    def recording_band_sums(*a, **kw):
        captured.append((a, kw))
        return run_band(*a, **kw)

    reset_counts()
    tic = time.perf_counter()
    with mock.patch.object(bandext, "band_sums", recording_band_sums):
        res16 = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    result["band_extract_bf16"]["launches"] = BAND_EXTRACT_BF16.launches
    print(f"phase 3b slice: bfloat16 cubes cast on the card from phase 3's ({gb:.1f} GB in "
          f"{cast_s:.2f} s); {len(sids)} targets in {wall:.2f} s = {len(sids) / wall:.1f} "
          f"targets/s ({card}); band kernel launches: bfloat16 {BAND_EXTRACT_BF16.launches}, "
          f"float32 {BAND_EXTRACT.launches}", flush=True)
    check(BAND_EXTRACT_BF16.launches > 0, "phase 3b did not launch the bfloat16 band kernel")
    check(BAND_EXTRACT.launches == 0, "phase 3b: a bfloat16 cube reached the float32 kernel")
    band_main_phase(captured, card, "3b")
    captured.clear()

    rel, err_rel, n_cmp = [], [], 0
    for a, b in zip(results32, res16):
        check(a.status == b.status, f"phase 3b: TIC {a.starid} status {b.status} != {a.status}")
        check((a.mask is None) == (b.mask is None)
              and (a.mask is None or np.array_equal(a.mask, b.mask)),
              f"phase 3b: TIC {a.starid} mask differs from phase 3's")
        if a.status not in (STATUS.OK, STATUS.WARNING):
            continue
        fa, fb = a.lightcurve["flux"], b.lightcurve["flux"]
        ok = np.isfinite(fa) & np.isfinite(fb)
        rel.append(np.abs(fb[ok] / fa[ok] - 1))
        ea, eb = a.lightcurve["flux_err"], b.lightcurve["flux_err"]
        err_rel.append(np.abs(eb[ok] / ea[ok] - 1))
        n_cmp += 1
    rel, err_rel = np.concatenate(rel), np.concatenate(err_rel)
    p99, med, e99 = (float(np.quantile(rel, 0.99)), float(np.median(rel)),
                     float(np.quantile(err_rel, 0.99)))
    print(f"phase 3b against phase 3 (float32): statuses and masks equal for {len(sids)} "
          f"targets; {n_cmp} OK/WARNING light curves, {rel.size} cadences: flux |rel| p99 "
          f"{p99:.3g} (bound 1.5e-3), median {med:.3g} (5e-4), max {rel.max():.3g}; flux_err "
          f"|rel| p99 {e99:.3g} (1e-2)", flush=True)
    check(p99 < 1.5e-3 and med < 5e-4 and e99 < 1e-2,
          "phase 3b: bfloat16 fluxes outside tests/test_engine_extras.py's bounds")
    del res16

    # PSF, linPSF and halo forced by method, on the card and on a CPU copy:
    ctx._context_prf = prf
    host = dict(ctx_kw, images=ctx.images.cpu(), images_err=ctx.images_err.cpu(),
                backgrounds=ctx.backgrounds.cpu(), pixelflags=ctx.pixelflags.cpu(),
                device="cpu")
    cpu = SectorContext.from_arrays(**host, cube_dtype=torch.bfloat16)
    cpu._context_prf = PRF(prf.iprf, prf.oversample, prf.center_x, prf.center_y,
                           info=dict(prf.info), device="cpu")
    for method, n in (("psf", N_PSF_PLAIN), ("linpsf", 16), ("halo", 4)):
        tasks = [{"priority": i + 1, "starid": sid, "sector": 1, "camera": 1, "ccd": 1,
                  "cadence": 1800, "datasource": "ffi", "method": method}
                 for i, sid in enumerate(sids[:n])]
        torch.cuda.synchronize()
        tic = time.perf_counter()
        got = photometry_batch(ctx, tasks, save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        want = photometry_batch(cpu, tasks[:P7_PARITY], save=False)
        good = [r for r in got if r.status in (STATUS.OK, STATUS.WARNING)
                and np.isfinite(r.lightcurve["flux"]).mean() > 0.99]
        check(len(good) >= 0.9 * n, f"phase 3b {method}: {len(good)} of {n} OK and finite")
        worst = 0.0
        for g, w in zip(got, want):
            check(g.method == w.method == method and g.status == w.status,
                  f"phase 3b {method}: TIC {g.starid} {g.method} {g.status} on the card, "
                  f"{w.method} {w.status} on the CPU")
            if not w.lightcurve:
                continue
            a, b = g.lightcurve["flux"], w.lightcurve["flux"]
            if method == "psf":     # the card's fused kernel against the CPU's plain fitter
                ok = (np.abs(a - b) <= 2e-2 * np.abs(b)) | (np.isnan(a) & np.isnan(b))
                check(ok.mean() >= 0.99, f"phase 3b psf: TIC {g.starid} within phase 4's "
                      f"bounds at {ok.mean():.3f} of cadences")
                worst = max(worst, float(1 - ok.mean()))
                continue
            rtol, atol = (1e-4, 1e-4 * np.nanmedian(np.abs(b))) if method == "linpsf" \
                else (5e-4, 0.0)
            d = np.abs(a - b)
            check(bool(np.all((d <= atol + rtol * np.abs(b)) | (np.isnan(a) & np.isnan(b)))),
                  f"phase 3b {method}: TIC {g.starid} differs from the CPU by {np.nanmax(d):.3g}")
            worst = max(worst, float(np.nanmax(d / (atol + rtol * np.abs(b) + 1e-300))))
        print(f"phase 3b {method} on the bfloat16 context: {n} targets in {wall:.2f} s, "
              f"{len(good)} OK/WARNING and finite; the first {P7_PARITY} == a CPU re-run on a "
              f"host copy of the bfloat16 cube ("
              + ("share of cadences outside flux rtol 2e-2 " if method == "psf" else
                 "max |diff| / bound ")
              + f"{worst:.3g}) ({card})", flush=True)
    cpu.close()
    ctx.close()
    del cpu, host, ctx, cubes, captured
    torch.cuda.empty_cache()


def make_sector(img0, gen, dev, T_, dtype, where):
    """make_cubes at ``T_`` frames, each 64-frame block made in float32 on
    the card and stored on ``where`` with the value planes in ``dtype``:
    bfloat16 on the card (cast there) for phase 3b's sector, float32 on the
    host for phase 3c's.  The same generator state gives the same draws, so
    the two are one cube in two dtypes."""
    import torch
    base = torch.as_tensor(img0, device=dev)
    sigma = torch.sqrt(torch.clamp(base, min=0.0) + 25.0)
    images = torch.empty(T_, H, W, device=where, dtype=dtype)
    errs = torch.empty(T_, H, W, device=where, dtype=dtype)
    bkgs = torch.empty(T_, H, W, device=where, dtype=dtype)
    flags = torch.empty(T_, H, W, device=where, dtype=torch.uint8)
    for t0 in range(0, T_, 64):
        n = min(64, T_ - t0)
        images[t0:t0 + n] = base + sigma * torch.randn(n, H, W, device=dev, generator=gen)
        errs[t0:t0 + n] = sigma
        bkgs[t0:t0 + n] = 20.0 + torch.randn(n, H, W, device=dev, generator=gen)
        flags[t0:t0 + n] = (torch.rand(n, H, W, device=dev, generator=gen) < 1e-4).to(torch.uint8) * 4
    for cube in (images, errs, bkgs):            # scattered NaN pixels
        idx = torch.randint(0, T_ * H * W, (2000,), device=dev, generator=gen)
        cube.view(-1)[idx.to(cube.device)] = float("nan")
    return images, errs, bkgs, flags


def bf16_sector(work, dev, gen, img0, rows, cols, tmag, wcs, sids, card):
    """Phase 3b (3): a full primary-mission sector, T = 1,312 in bfloat16
    (38.5 GB with the flags), made in frame blocks on the card;
    ``extract_aperture_batch`` on phase 3's targets: wall, targets/s, peak
    memory and the band launch's kernel time beside its bounds.  Returns
    the catalog's path and each target's (status, mask, flux, flux_err),
    which phase 3c holds its float32 sector to."""
    import torch
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16
    T_ = T_SECTOR
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    cubes = make_sector(img0, gen, dev, T_, torch.bfloat16, dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - tic
    gb = sum(x.numel() * x.element_size() for x in cubes) / 1e9
    folder = os.path.join(work, "phase3b")
    os.makedirs(folder)
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    cat = make_catalog_from_arrays(folder, 1, 1, 1, starid=np.arange(1, len(rows) + 1),
                                   ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(len(rows)),
                                   pm_dec=np.zeros(len(rows)), tmag=tmag,
                                   reference_time=2458340.0)
    ctx = SectorContext.from_arrays(
        images=cubes[0], images_err=cubes[1], backgrounds=cubes[2], pixelflags=cubes[3],
        sumimage=img0, time=1325.3 + np.arange(T_) / 48.0, timecorr=np.zeros(T_, np.float32),
        cadenceno=np.arange(T_, dtype=np.int32), quality=np.zeros(T_, np.int32),
        catalog_path=cat, wcs=wcs, sector=1, camera=1, ccd=1, input_folder=folder,
        cube_dtype=torch.bfloat16, device=dev)
    check(ctx.images.data_ptr() == cubes[0].data_ptr(), "phase 3b: from_arrays copied the cube")
    captured, run_band = [], bandext.band_sums

    def recording_band_sums(*a, **kw):
        captured.append((a, kw))
        return run_band(*a, **kw)

    reset_counts()
    tic = time.perf_counter()
    with mock.patch.object(bandext, "band_sums", recording_band_sums):
        res = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(BAND_EXTRACT_BF16.launches > 0 and BAND_EXTRACT.launches == 0,
          f"phase 3b sector: band launches bfloat16 {BAND_EXTRACT_BF16.launches}, float32 "
          f"{BAND_EXTRACT.launches}")
    good = [r for r in res if r.status in (STATUS.OK, STATUS.WARNING)]
    fin = min(float(np.isfinite(r.lightcurve["flux"]).mean()) for r in good)
    print(f"phase 3b sector: ({T_}, {H}, {W}) cubes in bfloat16 on the card, {gb:.1f} GB made "
          f"in {made:.1f} s; {len(sids)} targets in {wall:.2f} s = {len(sids) / wall:.1f} "
          f"targets/s; peak memory {peak:.1f} GB ({held:.1f} GB held before the cubes were "
          f"made) of the card's {torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f}; "
          f"{len(good)} OK or "
          f"WARNING, finite flux share min {fin:.4f} ({card})", flush=True)
    check(len(good) >= 0.9 * len(sids) and fin > 0.99 and peak < 80.0,
          "phase 3b sector: statuses, finite fluxes or peak memory out of bounds")
    band_main_phase(captured, card, "3b sector")
    captured.clear()
    ctx.close()
    keep = {r.starid: (r.status, r.mask, r.lightcurve.get("flux"), r.lightcurve.get("flux_err"))
            for r in res}
    del ctx, cubes, res, captured
    torch.cuda.empty_cache()
    return cat, keep


# --- phase 3c: host-resident cubes streamed through the card --------------------

STREAM_CHUNK = 128                       # _extract_flux_streamed's frames a chunk (as JAX's)


def meminfo() -> dict:
    """/proc/meminfo's MemTotal and MemAvailable, in bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, val = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def lc_bits_equal(a, b) -> bool:
    """Two light-curve arrays equal bit for bit (NaN payloads and signed zeros too)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def host_slice(ctx_kw, dev_ctx, sids, results32, prf, card):
    """Phase 3c (a): phase 3's float32 cube copied to the host, a host
    context over it (``SectorContext.from_arrays(..., cache="host")``) and
    ``extract_aperture_batch`` on phase 3's targets, streamed through the
    card: the band kernel launched ceil(T/128) times, statuses, masks and
    every light-curve array bit-equal to phase 3's; then PSF on 128 targets,
    linPSF on 16 and halo on 4, forced by ``method``, equal to the same calls
    on phase 3's device context."""
    import torch
    from photometry_tpu_torch.core.dispatcher import photometry_batch
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, PSF_WARM_FIT
    names = ("images", "images_err", "backgrounds", "pixelflags")
    torch.cuda.synchronize()
    tic = time.perf_counter()
    host_kw = dict(ctx_kw, cache="host", **{k: ctx_kw[k].cpu() for k in names})
    ctx = SectorContext.from_arrays(**host_kw)
    copy_s = time.perf_counter() - tic
    check(ctx.cache == "host" and all(getattr(ctx, k).device.type == "cpu" for k in names)
          and ctx.images.data_ptr() == host_kw["images"].data_ptr(),
          "phase 3c: the host context's cubes are not the host copies")
    gb = sum(getattr(ctx, k).numel() * getattr(ctx, k).element_size() for k in names) / 1e9
    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    want = -(-T // STREAM_CHUNK)
    print(f"phase 3c slice: phase 3's cubes copied to the host ({gb:.1f} GB in {copy_s:.2f} s), "
          f"a cache=\"host\" context; {len(sids)} targets streamed in {wall:.2f} s = "
          f"{len(sids) / wall:.1f} targets/s ({card}); band kernel launches "
          f"{BAND_EXTRACT.launches} (ceil({T}/{STREAM_CHUNK}) = {want})", flush=True)
    check(BAND_EXTRACT.launches == want, f"phase 3c: {BAND_EXTRACT.launches} band launches, "
          f"not {want}")
    keys = ("flux", "flux_err", "flux_background", "pos_centroid", "pos_corr",
            "shenanigans_any", "time")
    n_lc = 0
    for a, b in zip(results32, res):
        check(a.status == b.status, f"phase 3c: TIC {a.starid} status {b.status} != {a.status}")
        check((a.mask is None) == (b.mask is None)
              and (a.mask is None or np.array_equal(a.mask, b.mask)),
              f"phase 3c: TIC {a.starid} mask differs from phase 3's")
        check(a.mask is None or lc_bits_equal(a.aperture_image, b.aperture_image),
              f"phase 3c: TIC {a.starid} APERTURE image differs")
        check(a.lightcurve.keys() == b.lightcurve.keys(), f"phase 3c: TIC {a.starid} keys")
        for k in keys:
            if k in a.lightcurve:
                check(lc_bits_equal(a.lightcurve[k], b.lightcurve[k]),
                      f"phase 3c: TIC {a.starid} {k} differs from phase 3's")
        n_lc += bool(a.lightcurve)
    print(f"phase 3c against phase 3 (the device path): statuses, masks and APERTURE images "
          f"equal for {len(sids)} targets; {n_lc} light curves bit-equal in "
          + ", ".join(keys), flush=True)
    del res

    ctx._context_prf = dev_ctx._context_prf = prf
    for method, n in (("psf", N_PSF_PLAIN), ("linpsf", 16), ("halo", 4)):
        tasks = [{"priority": i + 1, "starid": sid, "sector": 1, "camera": 1, "ccd": 1,
                  "cadence": 1800, "datasource": "ffi", "method": method}
                 for i, sid in enumerate(sids[:n])]
        reset_counts()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        got = photometry_batch(ctx, tasks, save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        fits = PSF_WARM_FIT.launches
        want = photometry_batch(dev_ctx, tasks, save=False)
        check(method != "psf" or fits > 0, "phase 3c psf: the host context's fit did not "
              "launch the PSF kernel")
        good = 0
        for g, w in zip(got, want):
            check(g.method == w.method == method and g.status == w.status,
                  f"phase 3c {method}: TIC {g.starid} {g.method} {g.status} on the host "
                  f"context, {w.method} {w.status} on the device context")
            for k in ("flux", "flux_err", "flux_background", "pos_centroid"):
                if k in w.lightcurve:
                    check(lc_bits_equal(g.lightcurve[k], w.lightcurve[k]),
                          f"phase 3c {method}: TIC {g.starid} {k} differs from the device "
                          f"context's")
            good += g.status in (STATUS.OK, STATUS.WARNING) and bool(g.lightcurve)
        print(f"phase 3c {method} on the host context: {n} targets in {wall:.2f} s, {good} "
              f"OK/WARNING; statuses and light curves bit-equal to the device context's"
              + (f"; PSF kernel launches {fits}" if method == "psf" else "") + f" ({card})",
              flush=True)
    ctx.close()
    del ctx, host_kw
    torch.cuda.empty_cache()


def merged(spans):
    """(start, duration) spans -> their union as sorted (start, end) intervals."""
    out = []
    for a, d in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], a + d)
        else:
            out.append([a, a + d])
    return out


def overlap_share(kernels, copies) -> float:
    """The share of the kernels' device time during which a copy ran."""
    union = merged(copies)
    total = sum(d for _, d in kernels)
    inter = sum(max(0.0, min(a + d, hi) - max(a, lo)) for a, d in kernels for lo, hi in union)
    return inter / total if total else 0.0


def copy_profile(prof, gb, launches, what) -> str:
    """A profiled streamed extraction: the host-to-device copies' busy time
    and rate, the band kernels' time, the share of it that copies overlap,
    and the copies' busy share of the device activity's span."""
    copies = kernel_spans(prof, "Memcpy HtoD")
    kerns = kernel_spans(prof, "band_extract_kernel")
    check(len(kerns) == launches, f"{what} profile: {len(kerns)} band kernels, not {launches}")
    copy_busy = sum(hi - lo for lo, hi in merged(copies)) / 1e3
    kern_ms = sum(d for _, d in kerns) / 1e3
    span_ms = (max(x + d for x, d in copies + kerns) - min(x for x, _ in copies + kerns)) / 1e3
    return (f"{len(copies)} host-to-device copies busy {copy_busy:.1f} ms "
            f"({gb / (copy_busy / 1e3):.1f} GB/s while busy), {len(kerns)} band kernels "
            f"{kern_ms:.2f} ms ({kern_ms / len(kerns):.3f} ms a chunk), "
            f"{100 * overlap_share(kerns, copies):.1f}% of the kernels' time overlapped by "
            f"copies; device activity spans {span_ms:.1f} ms, copies busy "
            f"{100 * copy_busy / span_ms:.1f}% of it")


def host_sector(work, dev, seed, img0, catalog, wcs, sids, sector16, card):
    """Phase 3c (b): the full primary-mission sector, T = 1,312 in float32
    (71.5 GB with the flags), made on the card 64 frames at a time from the
    generator state phase 3b's bfloat16 sector was made from, and copied to
    pageable host memory; a host context, ``extract_aperture_batch`` on the
    10,240 targets streamed through the card.  Prints targets/s, the
    streamed extraction's wall and the host-to-device GB/s it reached beside
    a plain pinned copy's (measured here: the bound), the share of the band
    kernel's time that copies overlap and the copies' busy share
    (``torch.profiler``), peak device memory, MemTotal/MemAvailable; then
    the same extraction with the cubes pinned in place (cudaHostRegister),
    bit-equal.  Fluxes are held to phase 3b's bfloat16 sector within its
    bounds, statuses and masks equal."""
    import torch
    from photometry_tpu_torch.core import engine
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    frame = H * W * (3 * 4 + 1)
    mem = meminfo()
    # What the process holds beside the cube: staging buffers, the bound's
    # pinned frames, light curves, the interpreter and CUDA's host state.
    reserve = 12e9
    T_ = min(T_SECTOR, int((mem["MemAvailable"] - reserve) // frame))
    print(f"phase 3c sector host memory: MemTotal {mem['MemTotal'] / 1e9:.1f} GB, MemAvailable "
          f"{mem['MemAvailable'] / 1e9:.1f} GB; T = {T_}"
          + ("" if T_ == T_SECTOR else f" (cut from {T_SECTOR}: the cube must fit the host)")
          + f"; an extended-mission sector at 600 s (T = 3,900, {3900 * frame / 1e9:.1f} GB "
          f"against MemTotal {mem['MemTotal'] / 1e9:.1f} GB) is left out by the script",
          flush=True)
    check(T_ >= 4 * STREAM_CHUNK, "phase 3c sector: too little host memory for 512 frames")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tic = time.perf_counter()
    cubes = make_sector(img0, gen, dev, T_, torch.float32, "cpu")
    torch.cuda.synchronize()
    made = time.perf_counter() - tic
    gb = sum(x.numel() * x.element_size() for x in cubes) / 1e9
    ctx = SectorContext.from_arrays(
        images=cubes[0], images_err=cubes[1], backgrounds=cubes[2], pixelflags=cubes[3],
        sumimage=img0, time=1325.3 + np.arange(T_) / 48.0, timecorr=np.zeros(T_, np.float32),
        cadenceno=np.arange(T_, dtype=np.int32), quality=np.zeros(T_, np.int32),
        catalog_path=catalog, wcs=wcs, sector=1, camera=1, ccd=1, input_folder=work,
        cache="host", device=dev)
    check(ctx.images.data_ptr() == cubes[0].data_ptr() and not ctx.images.is_pinned(),
          "phase 3c sector: from_arrays copied the host cube")

    # The bound: a plain pinned copy of 32 frames of each plane to the card.
    src = [torch.empty((32, H, W), dtype=c.dtype, pin_memory=True) for c in cubes]
    dst = [torch.empty((32, H, W), dtype=c.dtype, device=dev) for c in cubes]
    for s_, c in zip(src, cubes):
        s_.copy_(c[:32])
    pinned_ms = cuda_ms(lambda: [d.copy_(s_, non_blocking=True) for d, s_ in zip(dst, src)])
    pinned_gbs = sum(x.numel() * x.element_size() for x in src) / 1e9 / (pinned_ms / 1e3)
    del src, dst

    real, stream_args, stream_walls = engine._extract_flux_streamed, [], []

    def timed_stream(*a, **kw):
        torch.cuda.synchronize()
        tic_ = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        stream_walls.append(time.perf_counter() - tic_)
        stream_args.append((a, kw))
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tic = time.perf_counter()
    with mock.patch.object(engine, "_extract_flux_streamed", timed_stream):
        res = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = BAND_EXTRACT.launches
    want = -(-T_ // STREAM_CHUNK)
    check(launches == want and len(stream_walls) == 1,
          f"phase 3c sector: {launches} band launches in {len(stream_walls)} streamed calls, "
          f"not {want} in 1")
    stream_s = stream_walls[0]
    chunk_gb = 2 * STREAM_CHUNK * frame / 1e9
    out_gb = len(sids) * 10 * T_ * 4 * 2 / 1e9
    print(f"phase 3c sector: ({T_}, {H}, {W}) float32 cubes on the host, {gb:.1f} GB made on the "
          f"card and copied to pageable host memory in {made:.1f} s; {len(sids)} targets in "
          f"{wall:.2f} s = {len(sids) / wall:.1f} targets/s; the streamed extraction "
          f"{stream_s:.2f} s = {gb / stream_s:.1f} GB/s host-to-device, beside a plain pinned "
          f"copy's {pinned_gbs:.1f} GB/s ({pinned_ms:.1f} ms for 32 frames of each plane): bound "
          f"{gb / pinned_gbs:.2f} s; band launches {launches} (ceil({T_}/{STREAM_CHUNK})); "
          f"peak device memory {peak:.1f} GB ({held:.1f} GB held before; two chunk buffers "
          f"{chunk_gb:.1f} GB, sums and their parts {out_gb:.2f} GB) ({card})", flush=True)
    check(peak - held < 0.4 * gb, "phase 3c sector: peak device memory is not far below the cube")

    # The streamed extraction again under torch.profiler: copies against kernels.
    a, kw = stream_args[0]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_out = real(*a, **kw)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - tic
    print(f"phase 3c sector profile, pageable cube (the streamed extraction, {prof_s:.2f} s "
          f"profiled): {copy_profile(prof, gb, want, 'phase 3c sector')} ({card})", flush=True)
    first_out = [x.clone() for x in prof_out]
    del prof, prof_out

    # The other design: the cube pinned in place when the context is made.
    cudart = torch.cuda.cudart()
    tic = time.perf_counter()
    for c in cubes:
        rc = cudart.cudaHostRegister(c.data_ptr(), c.numel() * c.element_size(), 0)
        check(int(rc) == 0, f"phase 3c sector: cudaHostRegister failed: {rc}")
    reg_s = time.perf_counter() - tic
    check(all(c.is_pinned() for c in cubes), "phase 3c sector: registered cubes not pinned")
    reps = []
    for _ in range(2):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        pin_out = real(*a, **kw)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - tic)
    check(all(bit_equal(x, y) for x, y in zip(pin_out[:4], first_out[:4]))
          and torch.equal(pin_out[4], first_out[4]),
          "phase 3c sector: the pinned cube's sums differ from the pageable one's")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        real(*a, **kw)
        torch.cuda.synchronize()
    pinned_profile = copy_profile(prof, gb, want, "phase 3c sector, pinned")
    del prof
    tic = time.perf_counter()
    for c in cubes:
        cudart.cudaHostUnregister(c.data_ptr())
    unreg_s = time.perf_counter() - tic
    print(f"phase 3c sector, the cube pinned in place instead: cudaHostRegister of {gb:.1f} GB "
          f"{reg_s:.2f} s; the streamed extraction {reps[0]:.2f} and {reps[1]:.2f} s = "
          f"{gb / min(reps):.1f} GB/s (pageable through the staging buffers: {stream_s:.2f} s); "
          f"sums bit-equal; unregister {unreg_s:.2f} s; profiled: {pinned_profile} ({card})",
          flush=True)
    del pin_out, first_out

    rel, err_rel, n_cmp = [], [], 0
    for r in res:
        status, mask, flux16, ferr16 = sector16[r.starid]
        check(r.status == status, f"phase 3c sector: TIC {r.starid} status {r.status} != "
              f"phase 3b's {status}")
        check((mask is None) == (r.mask is None) and (mask is None
                                                      or np.array_equal(mask, r.mask)),
              f"phase 3c sector: TIC {r.starid} mask differs from phase 3b's")
        if r.status not in (STATUS.OK, STATUS.WARNING):
            continue
        fa, fb = r.lightcurve["flux"], flux16[:T_]
        ok = np.isfinite(fa) & np.isfinite(fb)
        rel.append(np.abs(fb[ok] / fa[ok] - 1))
        err_rel.append(np.abs(ferr16[:T_][ok] / r.lightcurve["flux_err"][ok] - 1))
        n_cmp += 1
    rel, err_rel = np.concatenate(rel), np.concatenate(err_rel)
    p99, med, e99 = (float(np.quantile(rel, 0.99)), float(np.median(rel)),
                     float(np.quantile(err_rel, 0.99)))
    print(f"phase 3c sector against phase 3b's bfloat16 sector: statuses and masks equal for "
          f"{len(res)} targets; {n_cmp} OK/WARNING light curves, {rel.size} cadences: bfloat16 "
          f"flux |rel| p99 {p99:.3g} (bound 1.5e-3), median {med:.3g} (5e-4); flux_err |rel| "
          f"p99 {e99:.3g} (1e-2)", flush=True)
    check(p99 < 1.5e-3 and med < 5e-4 and e99 < 1e-2,
          "phase 3c sector: fluxes outside phase 3b's bounds against the bfloat16 sector")
    ctx.close()
    del ctx, cubes, res, stream_args, a, kw
    torch.cuda.empty_cache()


# --- phase 8: Target Pixel Files through the drain ------------------------------

def tpf_layout(rng, rows, cols, tmag):
    """Phase 8's primaries: isolated field stars of Tmag 8-11 (no star within
    12 px brighter than 2 mag fainter than they are: a brighter star just
    off a stamp puts its wings in the mask, as SPOC's crowding metrics
    would say), 30 px or more inside the CCD and from each other; the last
    one is the 20-s target.  Returns
    their indices into the field and their stamp sides (the brightest eighth
    21x21, the next eighth 15x15, the rest 11x11)."""
    picked = []
    for i in rng.permutation(np.where((tmag >= 8.0) & (tmag <= 11.0))[0]):
        r, c = rows[i], cols[i]
        if min(r, c, H - 1 - r, W - 1 - c) < 30:
            continue
        d = np.hypot(rows - r, cols - c)
        if np.any((d < 12) & (d > 0) & (tmag < tmag[i] + 2)):
            continue
        if any(np.hypot(rows[j] - r, cols[j] - c) < 30 for j in picked):
            continue
        picked.append(int(i))
        if len(picked) == P8["tpf"] + 1:
            break
    check(len(picked) == P8["tpf"] + 1, f"phase 8: room for {len(picked)} TPF targets")
    idx = np.array(picked)
    main = idx[:-1][np.argsort(tmag[idx[:-1]], kind="stable")]
    sides = np.full(len(main), 11)
    q = len(main) // 8
    sides[:q], sides[q:2 * q] = 21, 15
    return main, sides, int(idx[-1])


def tpf_signal(dev, gen, rows, cols, tmag, i, r0, c0, side, t, pos_corr, amp, period, phase):
    """A TPF's (T, side, side) flux, flux_err and background on the card:
    every field star within 8 px of the stamp, at its position plus
    ``pos_corr`` (col, row) in each cadence, rendered as make_field renders
    them (a sampled Gaussian, sigma 1.2 px); star ``i`` carries the sinusoid
    ``1 + amp * sin(2 pi t / period + phase)``; Gaussian noise of
    sqrt((flux + 20 e-/s) / 96 s + (10 / 96)^2) on a 20 e-/s background
    (FLUX_BKG), as photometry_tpu/sim's TPFs."""
    import torch
    T_ = len(t)
    near = np.where((rows > r0 - 8) & (rows < r0 + side + 8)
                    & (cols > c0 - 8) & (cols < c0 + side + 8))[0]
    yy = torch.arange(r0, r0 + side, device=dev, dtype=torch.float64)[None, :, None]
    xx = torch.arange(c0, c0 + side, device=dev, dtype=torch.float64)[None, None, :]
    dc = torch.as_tensor(pos_corr[:, 0], device=dev, dtype=torch.float64)[:, None, None]
    dr = torch.as_tensor(pos_corr[:, 1], device=dev, dtype=torch.float64)[:, None, None]
    tt = torch.as_tensor(t, device=dev, dtype=torch.float64)
    flux = torch.zeros(T_, side, side, device=dev, dtype=torch.float64)
    for j in near:
        f = float(10 ** (-0.4 * (tmag[j] - 20.451)))
        fj = f * (1 + amp * torch.sin(2 * np.pi * tt / period + phase)) if j == i else \
            torch.full_like(tt, f)
        g = torch.exp(-0.5 * ((yy - rows[j] - dr) ** 2 + (xx - cols[j] - dc) ** 2) / 1.2 ** 2)
        flux += fj[:, None, None] * g / (2 * np.pi * 1.2 ** 2)
    sigma = torch.sqrt((flux + 20.0) / 96.0 + (10.0 / 96.0) ** 2)
    flux = flux + sigma * torch.randn(flux.shape, device=dev, dtype=torch.float64, generator=gen)
    return (flux.float().cpu().numpy(), sigma.float().cpu().numpy(),
            np.full((T_, side, side), 20.0, np.float32))


def write_phase8(folder, dev, gen, rng, rows, cols, tmag, wcs):
    """Phase 8's files: the catalog of phase 3's field, 128 primary TPFs
    (120 s, T = 19,728) and one 20-s TPF (T = 118,080), with POS_CORR
    drifting, a 1% sinusoid on each primary, a SPOC aperture (bit 1 on the
    stamp, 64 for CCD output B, 4 on its border, 2|8 on the 3x3 core), a few
    gzipped.  Returns the per-TPF truth and the todo's tasks."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.io import fits as pf
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    make_catalog_from_arrays(folder, 1, 1, 1, starid=np.arange(1, len(rows) + 1),
                             ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(len(rows)),
                             pm_dec=np.zeros(len(rows)), tmag=tmag, reference_time=2458340.0)
    main, sides, fast = tpf_layout(rng, rows, cols, tmag)
    truth, tasks = {}, []
    gz = set(rng.choice(len(main), P8["gzip"], replace=False).tolist())
    for k, (i, side, cadence) in enumerate(list(zip(main, sides, [120] * len(main)))
                                           + [(fast, 11, 20)]):
        T_ = P8["T"] if cadence == 120 else P8["fast_T"]
        t = 1325.3 + (np.arange(T_) + 0.5) * cadence / 86400
        days = t - t[0]
        pos_corr = np.stack([0.03 * days + 0.05 * np.sin(2 * np.pi * days / 1.1),
                             -0.02 * days + 0.04 * np.cos(2 * np.pi * days / 0.7)],
                            axis=1).astype(np.float32)
        r0 = int(round(rows[i])) - side // 2
        c0 = int(round(cols[i])) - side // 2
        period, phase = rng.uniform(1.0, 5.0), rng.uniform(0, 2 * np.pi)
        flux, err, bkg = tpf_signal(dev, gen, rows, cols, tmag, i, r0, c0, side, t - t[0],
                                    pos_corr, 0.01, period, phase)
        quality = np.zeros(T_, np.int32)
        quality[::2500] = 32                                  # Desat: out of the sum image
        aperture = np.full((side, side), 1 | 64, np.int32)
        aperture[[0, -1], :] |= 4
        aperture[:, [0, -1]] |= 4
        mid = side // 2
        aperture[mid - 1:mid + 2, mid - 1:mid + 2] |= 2 | 8
        ap_hdr = wcs.shifted(drow=r0, dcol=c0).to_header(pf.Header())
        ap_hdr.set("CRVAL1P", c0 + 1)
        ap_hdr.set("CRVAL2P", r0 + 1)
        sid = int(i) + 1
        name = (f"tess2020186164531-s0001-{sid:016d}-0120-s_"
                f"{'fast-' if cadence == 20 else ''}tp.fits" + (".gz" if k in gz else ""))
        write_tpf(os.path.join(folder, name), sid, 1, 1, 1,
                  {"TIME": t + 0.003, "TIMECORR": np.full(T_, 0.003, np.float32),
                   "CADENCENO": np.arange(T_, dtype=np.int32), "FLUX": flux, "FLUX_ERR": err,
                   "FLUX_BKG": bkg, "QUALITY": quality, "POS_CORR1": pos_corr[:, 0],
                   "POS_CORR2": pos_corr[:, 1]}, aperture, ap_hdr, cadence=cadence)
        truth[sid] = {"flux": float(10 ** (-0.4 * (tmag[i] - 20.451))), "cadence": cadence,
                      "mod": 1 + 0.01 * np.sin(2 * np.pi * (t - t[0]) / period + phase),
                      "pos_corr": pos_corr.astype(np.float64), "aperture": aperture,
                      "time": t, "gz": k in gz}
        tasks.append((sid, float(tmag[i]), "tpf", cadence))
        # Secondary targets, as the todo list finds them (todolist._tpf_targets):
        # catalog stars whose pixel lies inside the stamp and was collected.
        y, x = rows - r0, cols - c0
        inside = (x >= -0.5) & (y >= -0.5) & (x <= side - 0.5) & (y <= side - 0.5)
        inside[i] = False
        for j in np.where(inside & (tmag < 15.0))[0]:
            ry = min(int(np.round(y[j])), side - 1)
            rx = min(int(np.round(x[j])), side - 1)
            if aperture[ry, rx] & 1:
                tasks.append((int(j) + 1, float(tmag[j]), f"tpf:{sid}", cadence))
    return truth, tasks, set(int(i) + 1 for i in main) | {fast + 1}


def tpf_phase(work, dev, gen, rng, ctx_kw, rows, cols, tmag, wcs, card):
    """Phase 8: Target Pixel Files through ``run_drain`` (see the module docstring)."""
    import sqlite3
    import torch
    from photometry_tpu_torch.core import dispatcher, drain
    from photometry_tpu_torch.core.engine import SectorContext
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16
    from photometry_tpu_torch.todolist import make_todo
    folder = os.path.join(work, "phase8")
    os.makedirs(folder)
    tic = time.perf_counter()
    truth, tasks, primaries = write_phase8(folder, dev, gen, rng, rows, cols, tmag, wcs)
    written = time.perf_counter() - tic
    # The TPF rows from the port's todo list, held to those write_phase8 found:
    tic = time.perf_counter()
    todo = make_todo(folder)
    todo_wall = time.perf_counter() - tic
    with sqlite3.connect(todo) as conn:
        made = set(conn.execute("SELECT starid, datasource, cadence FROM todolist"))
    want = {(sid, ds, cad) for sid, _, ds, cad in tasks}
    check(made == want, f"phase 8: make_todo's TPF rows differ from the phase's own: "
          f"{len(made - want)} extra, {len(want - made)} missing")
    # FFI tasks on phase 3's context, in the same magnitude range:
    pool = [int(j) + 1 for j in np.where((tmag >= 8.0) & (tmag <= 11.0))[0]]
    ffi = [(int(sid), float(tmag[sid - 1]), "ffi", 1800)
           for sid in rng.choice(pool, P8["ffi"], replace=False)]
    add_tasks(todo, ffi)
    tasks += ffi
    n_sec = sum(t_[2].startswith("tpf:") for t_ in tasks)
    n_bytes = sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder)
                  if "_tp" in f)
    print(f"phase 8 inputs: {len(truth) - 1} primary TPFs of {P8['T']} cadences at 120 s "
          f"(11x11, 15x15 and 21x21), one 20-s TPF of {P8['fast_T']} cadences, {P8['gzip']} "
          f"gzipped, {n_bytes / 1e9:.2f} GB of files, written in {written:.1f} s; make_todo "
          f"of the TPF rows ({len(truth)} primaries, {n_sec} secondaries, equal to the "
          f"phase's own) in {todo_wall:.2f} s ({card}), then {P8['ffi']} FFI tasks: "
          f"todo.sqlite of {len(tasks)} tasks", flush=True)

    ffi_ctx = SectorContext.from_arrays(**ctx_kw)
    real_open, run_batch, run_band = (dispatcher.open_context, drain.photometry_batch,
                                      bandext.band_sums)
    aperture, band_calls, walls = {}, [], {"tpf": 0.0, "ffi": 0.0}
    run_aperture = dispatcher.extract_aperture_batch

    def open_ctx(folder_, task, device="cuda", mesh=None):
        """Phase 3's context for FFI tasks; the drain's own TpfContext, timed, for TPF ones."""
        if task["datasource"] == "ffi":
            return ffi_ctx
        tic_ = time.perf_counter()
        out = real_open(folder_, task, device=device, mesh=mesh)
        walls["tpf"] += time.perf_counter() - tic_
        return out

    def timed_batch(ctx_, batch, **kw):
        tic_ = time.perf_counter()
        out = run_batch(ctx_, batch, **kw)
        walls["ffi" if ctx_.datasource == "ffi" else "tpf"] += time.perf_counter() - tic_
        return out

    def seen_aperture(ctx_, starids, **kw):
        out = run_aperture(ctx_, starids, **kw)
        for r in out:
            primary = getattr(getattr(ctx_, "tpf", None), "starid", None)
            key = ("ffi" if ctx_.datasource == "ffi" else
                   "tpf" if r.starid == primary else f"tpf:{primary}")
            aperture[(key, r.starid)] = r
        return out

    def seen_band(*a, **kw):
        out = run_band(*a, **kw)
        band_calls.append((a, kw, out))
        return out

    timers = drain.new_timers()
    reset_counts()
    with mock.patch.object(dispatcher, "open_context", open_ctx), \
            mock.patch.object(drain, "photometry_batch", timed_batch), \
            mock.patch.object(dispatcher, "extract_aperture_batch", seen_aperture), \
            mock.patch.object(bandext, "band_sums", seen_band):
        n_done = drain.run_drain(folder, 1, method=None, batch_size=P8["batch"], timers=timers,
                                 device=dev)
    torch.cuda.synchronize()
    launches = BAND_EXTRACT.launches
    check(BAND_EXTRACT_BF16.launches == 0, "phase 8: a float32 cube went to the bfloat16 kernel")
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        rows_db = conn.execute(
            "SELECT t.starid, t.datasource, t.cadence, t.status, d.method_used, d.lightcurve "
            "FROM todolist t LEFT JOIN diagnostics d ON t.priority = d.priority").fetchall()
    final = {STATUS.OK.value, STATUS.WARNING.value, STATUS.ERROR.value, STATUS.SKIPPED.value}
    counts = {}
    for _, d, _, st, _, _ in rows_db:
        key = (d.split(":")[0], None if st is None else STATUS(st).name)
        counts[key] = counts.get(key, 0) + 1
    n_tpf = sum(t_[2] != "ffi" for t_ in tasks)
    t = timers
    print(f"phase 8 drain: {n_done} tasks in {t['wall']:.2f} s = {n_done / t['wall']:.1f} "
          f"tasks/s with products ({card}); lease {t['lease']:.2f} s, context "
          f"{t['context']:.2f} s, photometry {t['photometry']:.2f} s, save {t['save']:.2f} s "
          f"({t.get('n_products', 0)} products), sqlite {t['sqlite']:.2f} s; {t['n_batches']} "
          f"leases; TPF tasks {n_tpf} in {walls['tpf']:.2f} s of their contexts and leases = "
          f"{n_tpf / walls['tpf']:.1f} TPF tasks/s with products, FFI leases "
          f"{walls['ffi']:.2f} s; band kernel launches {launches}; statuses "
          + ", ".join(f"{k[0]} {k[1]} {v}" for k, v in sorted(counts.items(), key=str)),
          flush=True)
    check(all(st in final for _, _, _, st, _, _ in rows_db),
          f"phase 8: statuses left unfinished: {counts}")
    prim_status = {sid: st for sid, d, _, st, _, _ in rows_db if d == "tpf"}
    ok_like = (STATUS.OK.value, STATUS.WARNING.value, STATUS.SKIPPED.value)
    check(all(prim_status[s] in ok_like for s in primaries),
          f"phase 8: a TPF primary ended outside OK, WARNING, SKIPPED: {counts}")
    check(len(band_calls) == launches and launches > 0,
          f"phase 8: {len(band_calls)} band calls recorded, {launches} launches counted")

    # Every recorded band launch against plain on its own inputs:
    band_err, shapes = 0.0, set()
    for a, kw, got in band_calls:
        windows = a[7] if len(a) > 7 else kw.get("windows")
        band_err = max(band_err, band_sums_err(got, bandext.band_sums_plain(*a[:7], windows),
                                               "phase 8 band launch"))
        shapes.add(tuple(a[0].shape))
    print(f"phase 8 band kernel: {launches} launches on {len(shapes)} cube shapes (T x h x w "
          f"from {min(shapes)} to {max(shapes)}); each launch's sums == plain on its own inputs "
          f"(counts exact, max |diff| {band_err:.3g})", flush=True)

    # The primaries' light curves: flux, sinusoid, pos_corr; one APERTURE product:
    ratio, corr, dpos, ap_read = [], [], 0.0, 0
    fast = (0.0, np.inf, 0.0, np.nan)           # the 20-s TPF: finite share, rms_hour, std, ratio
    paths = {sid: lc for sid, d, _, st, _, lc in rows_db if d == "tpf" and lc}
    for sid in sorted(primaries):
        r = aperture.get(("tpf", sid))
        if r is None or r.status not in (STATUS.OK, STATUS.WARNING):
            continue
        tr = truth[sid]
        fl = r.lightcurve["flux"]
        ok = np.isfinite(fl)
        if tr["cadence"] == 20:
            fast = (float(ok.mean()), float(r.details["rms_hour"]), float(np.nanstd(fl)),
                    float(np.nanmedian(fl) / tr["flux"]))
            continue
        ratio.append(float(np.median(fl[ok]) / tr["flux"]))
        corr.append(float(np.corrcoef(fl[ok] / np.median(fl[ok]), tr["mod"][ok])[0, 1]))
        pc = tr["pos_corr"]
        tnc = tr["time"]                      # TIME - TIMECORR: the written grid
        ref = int(np.argmin(np.abs(tnc - 1340.0)))
        dpos = max(dpos, float(np.abs(r.lightcurve["pos_corr"] - (pc - pc[ref])).max()))
        if ap_read == 0 and sid in paths:
            hdus = pf.read_fits(os.path.join(folder, paths[sid]))
            ap = np.asarray(hdus[[h.name for h in hdus].index("APERTURE")].data)
            check(np.array_equal(ap & ~10, tr["aperture"] & ~10)
                  and np.array_equal(ap & 10 == 10, r.mask),
                  f"phase 8: TIC {sid}'s APERTURE product lost the SPOC bits")
            ap_read += 1
            print(f"phase 8 products: {native_state('8')}; "
                  f"{product_twice('8', os.path.join(folder, paths[sid]), work)}", flush=True)
    print(f"phase 8 TPF primaries: {len(ratio)} OK/WARNING at 120 s: median flux / injected "
          f"{min(ratio):.3f}-{max(ratio):.3f}, light curve vs the 1% sinusoid r min "
          f"{min(corr):.3f} (median {np.median(corr):.3f}); pos_corr vs the written POS_CORR "
          f"(re-zeroed at the reference time) max |diff| {dpos:.2g} px; {ap_read} APERTURE "
          f"product read back with the SPOC bits; 20-s TPF: finite {fast[0]:.4f}, rms_hour "
          f"{fast[1]:.4g} < nanstd {fast[2]:.4g}, median / injected {fast[3]:.3f}", flush=True)
    check(len(ratio) >= 0.9 * P8["tpf"], f"phase 8: {len(ratio)} TPF primaries OK/WARNING")
    check(0.8 < min(ratio) and max(ratio) < 1.2, "phase 8: a TPF flux is off its injected one")
    check(min(corr) > 0.5, "phase 8: a TPF light curve does not follow its sinusoid")
    # The motion model shifts float32 CCD positions (~2,000 px): two ulps there.
    check(dpos < 5e-4, "phase 8: pos_corr does not follow the written POS_CORR")
    check(ap_read == 1, "phase 8: no APERTURE product read back")
    check(fast[0] > 0.95 and fast[1] < fast[2], "phase 8: the 20-s TPF's light curve")

    # The kernel alone at the TPF shapes, beside its bytes bound:
    for T_want, side in ((P8["T"], 11), (P8["fast_T"], 11)):
        a, kw, _ = next(c for c in band_calls if tuple(c[0][0].shape) == (T_want, side, side))
        windows = a[7] if len(a) > 7 else kw.get("windows")
        launch, _ = band_launcher(tuple(a[:4]), *a[4:7], windows)
        alone = cuda_ms(launch, reps=20)
        wrapped = cuda_ms(lambda: bandext.band_sums_cuda(*a[:7], windows), reps=20)
        short, _ = band_launcher(tuple(x[:32] for x in a[:4]), *a[4:7], windows)
        floor = cuda_ms(short, reps=20)
        m = a[4].cpu().numpy()
        bound = band_bytes(m, T_want, None if windows is None else windows.cpu().numpy()) \
            / PEAK_BYTES * 1e3
        print(f"phase 8 band kernel at N={m.shape[0]}, T={T_want}, {side}x{side} "
              f"({int(m.sum())} mask pixels): alone {alone:.4f} ms, band_sums_cuda "
              f"{wrapped:.4f} ms, the same launch at T=32 {floor:.4f} ms; bound {bound:.4f} ms "
              f"by bytes ({card})", flush=True)
    del band_calls, aperture, ffi_ctx
    torch.cuda.empty_cache()
    return folder


# --- phase 5: the prepare slice -------------------------------------------------

class DictCube:
    """The ``io.cube.ImageCube`` methods the prepare stage and the todo list
    use, on host arrays (the card's machine has no h5py).  Reads return
    copies, as h5py does; ``header`` is the cube's attributes (``header``,
    the ones a cube file is created with, then those the prepare stage
    writes).  It also keeps the first chunk's raw background fit and the
    first frames' residuals, which the stage overwrites or drops, for the
    plain re-runs."""

    def __init__(self, n_times, shape, keep_frames=8, header=None):
        self.n_times, self.shape = n_times, tuple(shape)
        # Attributes as ImageCube.create stores them (None values left out):
        self.attrs = {k: v for k, v in (header or {}).items() if v is not None}
        self.stages, self.vectors = set(), {}
        full = (n_times,) + self.shape
        self.arrays = {k: np.zeros(full, np.float32) for k in ("images", "images_err",
                                                               "backgrounds")}
        self.arrays["pixelflags"] = np.zeros(full, np.uint8)
        self.wcs = [""] * n_times
        self.scratch = self.raw_backgrounds = self.kept_resid = None
        self.keep_frames = keep_frames
        self._sumimage = self.pixels_used = None
        self.movement_kernel = self.movement_attrs = None

    def is_done(self, stage):
        return stage in self.stages

    def mark_done(self, stage):
        self.stages.add(stage)

    def write_movement_kernel(self, kernels, warpmode, ref_frame):
        self.movement_kernel = np.array(kernels, np.float64)
        self.movement_attrs = {"warpmode": warpmode, "ref_frame": int(ref_frame)}

    def write_block(self, name, t0, block):
        if name == "backgrounds" and t0 == 0 and self.raw_backgrounds is None:
            self.raw_backgrounds = block.copy()
        self.arrays[name][t0:t0 + block.shape[0]] = block

    def write_frame(self, k, image=None, image_err=None, background=None, pixelflags=None,
                    wcs_str=None):
        for name, v in (("images", image), ("images_err", image_err),
                        ("backgrounds", background), ("pixelflags", pixelflags)):
            if v is not None:
                self.arrays[name][k] = v
        if wcs_str is not None:
            self.wcs[k] = wcs_str

    def images(self, t0=0, t1=None):
        return self.arrays["images"][t0:t1].copy()

    def backgrounds(self, t0=0, t1=None):
        return self.arrays["backgrounds"][t0:t1].copy()

    def pixelflags(self, t0=0, t1=None):
        return self.arrays["pixelflags"][t0:t1].copy()

    def write_vectors(self, **kw):
        self.vectors.update({k: np.array(v) for k, v in kw.items() if v is not None})

    time = property(lambda self: self.vectors["time"].copy())
    timecorr = property(lambda self: self.vectors["timecorr"].copy())
    cadenceno = property(lambda self: self.vectors["cadenceno"].copy())
    quality = property(lambda self: self.vectors["quality"].copy())
    sumimage = property(lambda self: self._sumimage.copy())

    def write_time_bounds(self, time_start, time_stop):
        self.vectors.update(time_start=np.array(time_start, np.float64),
                            time_stop=np.array(time_stop, np.float64))

    def time_bounds(self):
        return self.vectors["time_start"].copy(), self.vectors["time_stop"].copy()

    def write_sumimage(self, sumimage, pixels_used=None):
        self._sumimage = np.array(sumimage, np.float64)
        if pixels_used is not None:
            self.pixels_used = np.array(pixels_used, np.uint8)

    def wcs_strings(self):
        return list(self.wcs)

    header = property(lambda self: dict(self.attrs))

    def reference_wcs(self):
        """The WCS of the reference frame (attribute WCS_REF_FRAME), as
        ``ImageCube.reference_wcs`` parses it."""
        from photometry_tpu_torch.io.fits import Header
        from photometry_tpu_torch.io.wcs import TanWCS
        ref = self.wcs[int(self.attrs.get("WCS_REF_FRAME", 0))]
        return TanWCS.from_header(Header.from_bytes(ref.encode("ascii")))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def create_scratch(self):
        self.scratch = np.zeros((self.n_times,) + self.shape, np.float32)

    def write_scratch(self, t0, block):
        self.scratch[t0:t0 + block.shape[0]] = block

    def read_scratch(self, index):
        return self.scratch[index].copy()

    def delete_scratch(self):
        self.kept_resid = self.scratch[:self.keep_frames].copy()
        self.scratch = None


def write_tpf(path, ticid, sector, camera, ccd, columns, aperture, ap_header, cadence=120):
    """A Target Pixel File in the SPOC layout (gzipped if ``path`` ends in
    .gz): a primary header (TICID, SECTOR, CAMERA, CCD, DATA_REL), the
    PIXELS table of ``columns`` (TIME, TIMECORR, CADENCENO, FLUX, FLUX_ERR,
    QUALITY, optionally FLUX_BKG and POS_CORR1/2) with TIMEDEL, and the
    APERTURE image with ``ap_header`` (the stamp's WCS, CRVAL1P/CRVAL2P)."""
    from photometry_tpu_torch.io import fits as pf
    prim, pix = pf.Header(), pf.Header()
    for key, v in (("TELESCOP", "TESS"), ("TICID", int(ticid)), ("SECTOR", sector),
                   ("CAMERA", camera), ("CCD", ccd), ("DATA_REL", 38)):
        prim.set(key, v)
    pix.set("TIMEDEL", cadence / 86400)
    pf.write_fits(path, [pf.PrimaryHDU(None, header=prim),
                         pf.BinTableHDU(columns, header=pix, name="PIXELS"),
                         pf.ImageHDU(aperture, header=ap_header, name="APERTURE")],
                  checksum=False)


def prepare_inputs(folder, img0, rows, cols, tmag, wcs, dev, gen, T, raw=True):
    """T sector-27 FFIs of camera 1 CCD 1 (raw TESS geometry unless ``raw``
    is False), a catalog and one TPF in ``folder``.  Frames are made on the
    card: the star field ``img0`` on a sky of 150 e-/s with a glow rising
    towards the corner farthest from the camera centre, drifting 5% over
    the sector, with Poisson-like noise (480 s effective exposure) and a
    saturated 30x30 patch in one frame.  Returns the files, the sky
    (T, H, W), the patch, the frames the TPF flags, and the time grid."""
    import torch
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.io.settings import sector_info
    from photometry_tpu_torch.ops.background import radial_coordinates
    H, W = img0.shape
    sector, camera, ccd = PREP["sector"], PREP["camera"], PREP["ccd"]
    r = radial_coordinates((H, W), camera, ccd, col_offset=44 if raw else 0)
    glow = 150.0 + 400.0 * np.exp(-(r.max() - r) / 200.0)
    drift = 1.0 + 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    dt, bc, s0 = 600 / 86400, 0.003, 2041.6
    stars = torch.as_tensor(img0, device=dev)
    glow_t = torch.as_tensor(glow.astype(np.float32), device=dev)
    patch = (70 % T, slice(H // 2, H // 2 + 30), slice(W // 3, W // 3 + 30))
    files = []
    hdr_wcs = (wcs.shifted(dcol=-44) if raw else wcs).to_header()
    for k in range(T):
        signal = stars + glow_t * float(drift[k])
        err = torch.sqrt(torch.clamp(signal, min=0.0) / 480.0 + 0.01)
        frame = signal + err * torch.randn(H, W, device=dev, generator=gen)
        img, unc = frame.cpu().numpy(), err.cpu().numpy()
        if k == patch[0]:
            img[patch[1], patch[2]] += 1e5
        if raw:
            img_raw = np.zeros(RAW_SHAPE, np.float32)
            unc_raw = np.zeros(RAW_SHAPE, np.float32)
            img_raw[:H, 44:44 + W], unc_raw[:H, 44:44 + W] = img, unc
            img, unc = img_raw, unc_raw
        hdr = pf.Header()
        for key, v in (("TELESCOP", "TESS" if raw else "SIMTESS"), ("CAMERA", camera),
                       ("CCD", ccd), ("SECTOR", sector), ("DATA_REL", 38),
                       ("PROCVER", "spoc-5.0.20-20201228"),
                       ("TSTART", s0 + k * dt - dt / 2 + bc), ("TSTOP", s0 + k * dt + dt / 2 + bc),
                       ("EXPOSURE", 480 / 86400), ("BARYCORR", bc), ("FFIINDEX", 100000 + k),
                       ("NUM_FRM", 300), ("GAIN", 5.2), ("READNOIS", 10.0),
                       ("DQUALITY", 4 if k == 20 % T else 0)):
            hdr.set(key, v)
        path = os.path.join(folder, f"tess{2020186164531 + k:013d}-s{sector:04d}-{camera}-{ccd}"
                                    f"-0120-s_ffic.fits")
        pf.write_fits(path, [pf.PrimaryHDU(None, header=hdr),
                             pf.ImageHDU(img, header=hdr_wcs, name="CAL"),
                             pf.ImageHDU(unc, name="UNCERT")], checksum=False)
        files.append(path)
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    n = len(rows)
    make_catalog_from_arrays(folder, sector, camera, ccd, starid=np.arange(1, n + 1),
                             ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(n), pm_dec=np.zeros(n),
                             tmag=tmag, reference_time=sector_info(sector).reference_time)
    # One 2-min TPF over the sector, Desat (32) in the cadences of two frames,
    # with its stamp's WCS (phase 9's todo finds its secondaries with it):
    nt = 5 * T
    u = s0 - dt / 2 + (np.arange(nt) + 0.5) * 120 / 86400
    quality = np.zeros(nt, np.int32)
    desat = sorted({10 % T, 50 % T})
    for f in desat:
        quality[5 * f + 2] = 32
    i, r0, c0 = phase5_tpf(rows, cols, tmag, (H, W))
    ap = wcs.shifted(drow=r0, dcol=c0).to_header(pf.Header())
    ap.set("CRVAL1P", c0 + 1)
    ap.set("CRVAL2P", r0 + 1)
    flux = np.full((nt, 11, 11), 100.0, np.float32)
    path = os.path.join(folder, f"tess2020186164531-s{sector:04d}-{i + 1:016d}-0120-s_tp.fits")
    write_tpf(path, i + 1, sector, camera, ccd,
              {"TIME": u + bc, "TIMECORR": np.full(nt, bc, np.float32),
               "CADENCENO": np.arange(nt, dtype=np.int32), "FLUX": flux,
               "FLUX_ERR": np.ones_like(flux), "QUALITY": quality},
              np.ones((11, 11), np.int32), ap)
    sky = (glow[None] * drift[:, None, None]).astype(np.float32)
    tpf = {"path": path, "index": i, "r0": r0, "c0": c0, "side": 11}
    return files, sky, patch, desat, s0 + np.arange(T) * dt + bc, tpf


def phase5_tpf(rows, cols, tmag, shape, side=11):
    """Phase 5's TPF target: a star fainter than the 4,096 brightest (so that
    phase 9's drain of the 2,048 highest priorities takes no TPF task), 20 px
    or more inside the CCD, whose side x side stamp holds two or more other
    stars, none of them among the 4,096 brightest either.  Returns its index
    into the field and the stamp's corner (row, col)."""
    rank = np.empty(len(tmag), int)
    rank[np.argsort(tmag, kind="stable")] = np.arange(len(tmag))
    faint = rank >= 2 * P9["todo"]
    for i in np.where(faint)[0]:
        r0, c0 = int(round(rows[i])) - side // 2, int(round(cols[i])) - side // 2
        if min(r0, c0) < 20 or r0 + side > shape[0] - 20 or c0 + side > shape[1] - 20:
            continue
        y, x = rows - r0, cols - c0
        inside = (x >= -0.5) & (y >= -0.5) & (x <= side - 0.5) & (y <= side - 0.5)
        inside[i] = False
        if inside.sum() >= 2 and faint[inside].all():
            return int(i), r0, c0
    fail("phase 5: no faint star with two faint neighbours in its stamp for the TPF")


def device_busy_ms(prof) -> float:
    """Union of the device activities (kernels, copies) of a profiled run, in ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def kernel_spans(prof, name):
    """(start, duration) in microseconds of the device activities of a
    profiled run whose name contains ``name``, in start order."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                  for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name)


def psf_profile(ctx, sids, wall, card, what) -> int:
    """``extract_psf_batch`` once more under torch.profiler: prints the fit
    kernel's device time, first-cadence and warm launches apart (each fused
    group chunk launches its first-cadence fit, then its warm fit), and its
    share of ``wall``, the unprofiled slice's; returns the launches seen."""
    import torch
    from photometry_tpu_torch.models import psf_fit
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        psf_fit.extract_psf_batch(ctx, sids)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - tic
    spans = [d / 1e3 for _, d in kernel_spans(prof, "psf_warm_fit_kernel")]
    check(len(spans) > 0 and len(spans) % 2 == 0, f"{len(spans)} psf_warm_fit launches profiled")
    first, warm = spans[0::2], spans[1::2]
    print(f"{what}: psf_warm_fit {len(spans)} launches, {sum(spans):.3f} ms on the device: "
          f"{len(first)} first-cadence {sum(first):.3f} ms (median {np.median(first):.4f}), "
          f"{len(warm)} warm {sum(warm):.3f} ms (median {np.median(warm):.4f}); "
          f"{100 * sum(spans) / (wall * 1e3):.2f}% of the unprofiled slice's {wall:.2f} s "
          f"({100 * sum(spans) / (prof_wall * 1e3):.2f}% of {prof_wall:.2f} s profiled, device "
          f"busy {device_busy_ms(prof):.1f} ms) ({card})", flush=True)
    return len(spans)


def photometry_context(work, rows, cols, tmag, cubes, dev):
    """Phase 3's ``SectorContext.from_arrays`` over the (images, errs,
    backgrounds, flags) cubes, with a TAN WCS and the field's catalog
    written to ``work``: (wcs, the keyword arguments, the context)."""
    import torch
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.core.engine import SectorContext
    images, errs, bkgs, flags = cubes
    wcs = field_wcs()
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    cat = make_catalog_from_arrays(work, 1, 1, 1, starid=np.arange(1, len(rows) + 1),
                                   ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(len(rows)),
                                   pm_dec=np.zeros(len(rows)), tmag=tmag,
                                   reference_time=2458340.0)
    ctx_kw = dict(
        images=images, images_err=errs, backgrounds=bkgs, pixelflags=flags,
        sumimage=torch.nanmean(images, dim=0).cpu().numpy(),
        time=1325.3 + np.arange(T) / 48.0, timecorr=np.zeros(T, np.float32),
        cadenceno=np.arange(T, dtype=np.int32), quality=np.zeros(T, np.int32),
        catalog_path=cat, wcs=wcs, sector=1, camera=1, ccd=1, input_folder=work, device=dev)
    return wcs, ctx_kw, SectorContext.from_arrays(**ctx_kw)


def top_device_ops(prof, k=8) -> str:
    """The k entries of a profiled run with the most device time, in ms."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        if t > 0:
            rows.append((t, e.key, e.count))
    return "; ".join(f"{key[:60]} {t / 1e3:.1f} ms x{c}" for t, key, c in sorted(rows)[::-1][:k])


def prepare_phase(work, img0, rows, cols, tmag, wcs, dev, gen, card, result,
                  T=PREP["T"], chunk=PREP["chunk"], raw=True):
    """Phase 5: the prepare stage on synthetic FFIs through ``prepare_cube``.
    Returns the prepared store and its TPF (path, field index, stamp corner)."""
    import torch
    from photometry_tpu_torch import prepare as prep
    from photometry_tpu_torch.core import motion
    from photometry_tpu_torch.core.pixelflags import manual_exclude_mask
    from photometry_tpu_torch.io.loader import iter_frames
    from photometry_tpu_torch.io.settings import sector_info
    from photometry_tpu_torch.io.tess import read_ffi
    from photometry_tpu_torch.ops._kernels import MEDIAN15, SEGMENT_HIST
    from photometry_tpu_torch.ops.background import radial_coordinates
    from photometry_tpu_torch.quality import PixelQualityFlags as PQ
    folder = os.path.join(work, "ffi")
    os.makedirs(folder, exist_ok=True)
    tic = time.perf_counter()
    files, sky, patch, desat, tmid, tpf = prepare_inputs(folder, img0, rows, cols, tmag, wcs,
                                                         dev, gen, T, raw=raw)
    H, W = img0.shape
    print(f"phase 5 inputs: {T} FFIs of {RAW_SHAPE if raw else (H, W)} (sector "
          f"{PREP['sector']}, camera {PREP['camera']} CCD {PREP['ccd']}), a catalog of "
          f"{len(rows)} stars, one TPF; written in {time.perf_counter() - tic:.1f} s", flush=True)

    sector, camera, ccd = PREP["sector"], PREP["camera"], PREP["ccd"]
    # The attributes prepare_one creates a cube file with:
    cube = DictCube(T, (H, W), header=prep._cube_header(read_ffi(files[0]), sector, camera,
                                                        ccd))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    reset_counts()
    tic = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        walls = prep.prepare_cube(cube, files, folder, sector, camera, ccd, device=dev,
                                  chunk=chunk)
    wall = time.perf_counter() - tic
    result["median15"]["launches"] = MEDIAN15.launches
    result["segment_hist"]["launches"] = SEGMENT_HIST.launches
    busy = device_busy_ms(prof)
    fps1 = T / (walls["backgrounds_fit"] + walls["backgrounds_smooth"])
    fps3 = T / walls["shenanigans"]
    print(f"phase 5 slice: prepare_cube of {T} frames (stages 1-5) in {wall:.2f} s ({card}); "
          "stage walls " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; stage 1 {fps1:.2f} frames/s, stage 3 {fps3:.2f} frames/s; device busy "
          f"{busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% of the wall (torch.profiler on); "
          f"launches median15 {MEDIAN15.launches}, segment_hist {SEGMENT_HIST.launches}; "
          f"{native_state('5')}", flush=True)
    print(f"phase 5 device time by kernel: {top_device_ops(prof)}", flush=True)
    med = [d / 1e3 for _, d in kernel_spans(prof, "median15_kernel")]
    if med:
        print(f"phase 5 median15: {len(med)} launches, device ms " + ", ".join(
            f"{d:.3f}" for d in med) + f" (total {sum(med):.3f}) ({card})", flush=True)
    hist = [(c + f) / 1e3 for (_, c), (_, f) in zip(kernel_spans(prof, "segment_hist_kernel"),
                                                    kernel_spans(prof, "to_float_kernel"))]
    if hist:
        print(f"phase 5 segment_hist: {len(hist)} launches, device time per launch (counts and "
              f"their float32 conversion) median "
              f"{np.median(hist):.4f} ms (min {min(hist):.4f}, max {max(hist):.4f}, total "
              f"{sum(hist):.4f}) ({card})", flush=True)
    check(MEDIAN15.launches > 0, "the prepare slice did not launch the median kernel")
    check(SEGMENT_HIST.launches > 0, "the prepare slice did not launch the histogram kernel")
    check(cube.stages == set(prep.STAGES), f"stage markers {sorted(cube.stages)}")

    # Stage 6, resumed on the prepared cube: the frames carry no injected motion.
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    walls6 = prep.prepare_cube(cube, files, folder, sector, camera, ccd, device=dev,
                               chunk=chunk, calc_movement_kernel=True)
    mem = ("" if dev.type != "cuda" else
           f"; peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above the "
           f"{base / 1e9:.2f} GB held")
    check(set(walls6) == {"movement"}, f"the resumed prepare_cube ran {sorted(walls6)}")
    check(cube.stages == set(prep.STAGES) | {"movement"}, f"stage markers {sorted(cube.stages)}")
    walls.update(walls6)
    kern, ref6 = cube.movement_kernel, cube.movement_attrs["ref_frame"]
    check(kern.shape == (T, 2) and cube.movement_attrs["warpmode"] == "translation",
          f"movement kernels {kern.shape}, {cube.movement_attrs}")
    amax = np.abs(kern).max(axis=1)
    worst = int(np.argmax(amax))
    sub = min(chunk, motion.ecc_sub_batch(H, W, "translation"))
    print(f"phase 5 stage 6 (resumed, profiler off): {T} movement kernels in "
          f"{walls['movement']:.2f} s = {T / walls['movement']:.1f} frames/s (sub-batches of "
          f"{sub} frames{mem}); largest |kernel| {amax[worst]:.4f} px at frame {worst} "
          f"(saturated patch in frame {patch[0]}), {amax[ref6]:.2e} px at the reference "
          f"frame {ref6}", flush=True)
    check(amax.max() < 0.05, f"a movement kernel of {amax.max():.3f} px on motionless frames")
    check(amax[ref6] < 0.005 and ref6 == cube.attrs["WCS_REF_FRAME"],
          "kernel at the reference frame")

    flags, bkg = cube.arrays["pixelflags"], cube.arrays["backgrounds"]
    used = (flags & PQ.NotUsedForBackground) == 0
    check(bool(np.isfinite(bkg[used]).all()), "backgrounds not finite on pixels used for them")
    d = np.abs(bkg - sky)[:, 16:-16, 16:-16][used[:, 16:-16, 16:-16]]
    med_d, p99_d = float(np.median(d)), float(np.percentile(d, 99))
    f_nub = float((~used).mean())
    she = (flags & PQ.BackgroundShenanigans) != 0
    k, rs, cs = patch
    inner = float(she[k, rs.start + 7:rs.stop - 7, cs.start + 7:cs.stop - 7].mean())
    she[k, rs, cs] = False
    other = float(she.mean())
    quality = cube.quality
    print(f"phase 5 checks: |background - injected sky| median {med_d:.3f}, p99 {p99_d:.3f} "
          f"e-/s on skies of {sky.min():.0f}-{sky.max():.0f}; NotUsedForBackground "
          f"{100 * f_nub:.2f}%, ManualExclude {int(((flags & PQ.ManualExclude) != 0).sum())}, "
          f"shenanigans on {inner:.3f} of the patch and {100 * other:.4f}% elsewhere; quality "
          f"{[int(quality[f]) for f in (20 % T, *desat)]} at frames {[20 % T, *desat]}; "
          f"WCS_REF_FRAME {cube.attrs['WCS_REF_FRAME']}", flush=True)
    # Bright stars' wings beyond the catalog mask pull the tile modes low by
    # ~1 e-/s (the JAX package's test_background_recovery allows 1.5 median):
    check(med_d < 3.0 and p99_d < 40.0, "backgrounds do not track the injected sky")
    check(f_nub < 0.5, "more than half the pixels NotUsedForBackground")
    check(inner > 0.9 and other < 1e-3, "shenanigans flags miss the patch or spread")
    check(all(quality[f] & 32 for f in desat) and quality[20 % T] & 4,
          "TPF / header quality not transferred")
    ref_tjd = sector_info(sector).reference_time - 2457000
    ref = int(np.argmin(np.where(quality == 0, np.abs(tmid - ref_tjd), np.inf)))
    check(cube.attrs["WCS_REF_FRAME"] == ref and all(cube.wcs), "WCS reference frame")

    # The first chunk's background fit and the first frames' residuals again,
    # with the plain versions of both kernels on the same device:
    n0 = min(chunk, T)
    frames = list(iter_frames(files[:n0]))
    stack = np.stack([f.data for f in frames])
    manex = np.stack([manual_exclude_mask(f.data, f.header, f.is_tess) for f in frames])
    src = prep._catalog_source_mask(folder, sector, camera, ccd, (H, W), frames[0].wcs)
    del frames
    reset_counts()
    bkg_plain, _ = prep.background_flags(
        torch.as_tensor(stack, device=dev), torch.as_tensor(manex, device=dev),
        torch.as_tensor(src, device=dev),
        radius_image=radial_coordinates((H, W), camera, ccd, col_offset=44 if raw else 0),
        tile=int(min(64, max(8, min(H, W) // 6))), plain=True)
    bkg_plain = bkg_plain.cpu().numpy()
    kk = cube.keep_frames
    resid_plain = prep.shenanigans_residual(
        torch.nan_to_num(torch.as_tensor(cube.images(0, kk), device=dev)),
        torch.as_tensor(cube.sumimage.astype(np.float32), device=dev), plain=True).cpu()
    check(MEDIAN15.launches == 0 and SEGMENT_HIST.launches == 0, "a plain re-run launched a kernel")
    same_bkg = np.array_equal(bkg_plain, cube.raw_backgrounds, equal_nan=True)
    same_resid = bit_equal(resid_plain, torch.as_tensor(cube.kept_resid))
    print(f"phase 5 plain re-run: first {n0} frames' background fit equal: {same_bkg} (max "
          f"|diff| {np.nanmax(np.abs(bkg_plain - cube.raw_backgrounds)):.3g}); {kk} frames' "
          f"residuals bit-equal: {same_resid}", flush=True)
    check(same_bkg, "first chunk's backgrounds differ between the kernel and the plain histogram")
    check(same_resid, "shenanigans residuals differ between the kernel and the plain median")
    return cube, tpf


# --- phase 9: catalog -> todo -> drain -> merge on phase 5's store ----------------

def chain_phase(work, dev, store, tpf, rows, cols, tmag, wcs, card):
    """Phase 9: the port's chain on phase 5's prepared store (see the module
    docstring).  Returns the walls of its steps."""
    import shutil
    import sqlite3
    import torch
    from photometry_tpu_torch import todolist
    from photometry_tpu_torch.catalog import StarCatalog
    from photometry_tpu_torch.cli import catalog_cmd, todo_merge_cmd
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    from photometry_tpu_torch.core.engine import SectorContext
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.io.cube import cube_filename
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    sector, camera, ccd = PREP["sector"], PREP["camera"], PREP["ccd"]
    H_, W_ = store.shape
    folder = os.path.join(work, "phase9")
    os.makedirs(folder)
    walls = {}

    # 1. The field as a TIC extract, with P9["off"] stars just off the science
    # area (catalog only), and the catalog from it through the catalog CLI:
    rng = np.random.default_rng(9)
    k = P9["off"] // 4
    off_r = np.concatenate([rng.uniform(-30, -1, k), rng.uniform(H_, H_ + 30, k),
                            rng.uniform(0, H_, 2 * k)])
    off_c = np.concatenate([rng.uniform(0, W_, 2 * k), rng.uniform(-30, -1, k),
                            rng.uniform(W_, W_ + 30, k)])
    all_r, all_c = np.concatenate([rows, off_r]), np.concatenate([cols, off_c])
    all_m = np.concatenate([tmag, rng.uniform(7.5, 13.0, 4 * k)])
    ra, dec = wcs.radec_of_rowcol(all_r, all_c)
    extract = os.path.join(work, "phase9_tic.npz")
    n = len(all_r)
    np.savez(extract, starid=np.arange(1, n + 1), ra=ra, dec=dec, pm_ra=np.zeros(n),
             pm_dec=np.zeros(n), tmag=all_m)
    tic = time.perf_counter()
    rc = catalog_cmd.main(["-q", "--camera", str(camera), "--ccd", str(ccd), "--tic-source",
                           extract, str(sector), folder])
    walls["catalog"] = time.perf_counter() - tic
    check(rc == 0, f"phase 9: catalog_cmd exited {rc}")
    with StarCatalog(os.path.join(folder, f"catalog_sector{sector:03d}_camera{camera}"
                                          f"_ccd{ccd}.sqlite")) as cat:
        check(len(cat) == n, f"phase 9: the catalog holds {len(cat)} of {n} stars")

    # 2. The todo list over the store (the cube file's name, its contents
    # read through todolist.open_cube from memory) and phase 5's TPF:
    open(os.path.join(folder, cube_filename(sector, camera, ccd)), "wb").close()
    os.symlink(tpf["path"], os.path.join(folder, os.path.basename(tpf["path"])))
    tic = time.perf_counter()
    with mock.patch.object(todolist, "open_cube", lambda path: store):
        todo = todolist.make_todo(folder)
    walls["todo"] = time.perf_counter() - tic
    with sqlite3.connect(todo) as conn:
        rows_db = conn.execute("SELECT priority, starid, datasource, tmag, method "
                               "FROM todolist ORDER BY priority").fetchall()
    ffi = [r[1] for r in rows_db if r[2] == "ffi"]
    on = set(np.where((all_c >= -0.5) & (all_r >= -0.5) & (all_c <= W_ - 0.5)
                      & (all_r <= H_ - 0.5))[0] + 1)
    lost = sum(c < 43.5 for c in all_c[np.array(sorted(on)) - 1])
    y, x = all_r - tpf["r0"], all_c - tpf["c0"]
    side = tpf["side"]
    inside = (x >= -0.5) & (y >= -0.5) & (x <= side - 0.5) & (y <= side - 0.5)
    inside[tpf["index"]] = False
    sid_tpf = tpf["index"] + 1
    want_tpf = {(sid_tpf, "tpf")} | {(int(j) + 1, f"tpf:{sid_tpf}") for j in np.where(inside)[0]}
    got_tpf = {(r[1], r[2]) for r in rows_db if r[2] != "ffi"}
    tm = [r[3] for r in rows_db]
    print(f"phase 9 todo: make_todo over phase 5's store ({H_}x{W_}, {store.n_times} frames) "
          f"and its TPF in {walls['todo']:.2f} s, {len(rows_db)} rows: {len(ffi)} ffi (of "
          f"{len(on)} stars on the science area, {n - len(on)} off it; {lost} of them in the "
          f"first 44 columns, which the JAX package's todo list drops on flight cubes), "
          f"{len(got_tpf)} TPF rows ({len(got_tpf) - 1} secondaries); catalog of {n} stars "
          f"by catalog_cmd in {walls['catalog']:.2f} s ({card})", flush=True)
    check(len(ffi) == len(set(ffi)) and set(ffi) == on,
          f"phase 9: the todo's FFI targets are not the stars on the science area "
          f"({len(set(ffi) - on)} extra, {len(on - set(ffi))} missing)")
    check(got_tpf == want_tpf and len(want_tpf) >= 3,
          f"phase 9: TPF rows {sorted(got_tpf)} != {sorted(want_tpf)}")
    check([r[0] for r in rows_db] == list(range(1, len(rows_db) + 1)) and tm == sorted(tm),
          "phase 9: priorities do not follow Tmag")

    # 3. The drain of the 2,048 highest priorities on a context over the store:
    ctx = SectorContext.from_arrays(
        images=store.arrays["images"], images_err=store.arrays["images_err"],
        backgrounds=store.arrays["backgrounds"], pixelflags=store.arrays["pixelflags"],
        sumimage=store.sumimage, time=store.time, timecorr=store.timecorr,
        cadenceno=store.cadenceno, quality=store.quality,
        catalog_path=os.path.join(folder, f"catalog_sector{sector:03d}_camera{camera}"
                                          f"_ccd{ccd}.sqlite"),
        wcs=store.reference_wcs(), sector=sector, camera=camera, ccd=ccd, header=store.header,
        input_folder=folder, device=dev)
    drained = list(range(1, P9["todo"] + 1))
    check(all(r[2] == "ffi" for r in rows_db[:P9["todo"]]),
          "phase 9: a TPF task among the drained priorities")
    timers = new_timers()
    reset_counts()
    torch.cuda.synchronize()
    with mock.patch.object(dispatcher, "open_context", lambda *a, **kw: ctx):
        n_done = run_drain(folder, 1, method=None, batch_size=P9["batch"], timers=timers,
                           constraints={"priority": drained}, device=dev)
    torch.cuda.synchronize()
    walls["drain"] = timers["wall"]
    launches = BAND_EXTRACT.launches
    ctx.close()
    with sqlite3.connect(todo) as conn:
        status = dict(conn.execute("SELECT priority, status FROM todolist"))
        methods = [m for (m,) in conn.execute("SELECT method_used FROM diagnostics")]
    final = {STATUS.OK.value, STATUS.WARNING.value, STATUS.ERROR.value, STATUS.SKIPPED.value}
    counts = {}
    for p in drained:
        key = None if status[p] is None else STATUS(status[p]).name
        counts[key] = counts.get(key, 0) + 1
    print(f"phase 9 drain: run_drain(method=None) over priorities 1-{P9['todo']}: {n_done} "
          f"tasks in {walls['drain']:.2f} s = {n_done / walls['drain']:.1f} tasks/s with "
          f"products ({card}); photometry {timers['photometry']:.2f} s, save "
          f"{timers['save']:.2f} s; statuses {counts}; methods "
          + ", ".join(f"{m} {methods.count(m)}" for m in sorted(set(methods)))
          + f"; band kernel launches {launches}", flush=True)
    check(all(status[p] in final for p in drained), f"phase 9: unfinished statuses {counts}")
    check(launches > 0, "phase 9: the drain did not launch the band kernel")
    check(sum(status[p] is not None for p in status if p > P9["todo"])
          == sum(status[p] == STATUS.SKIPPED.value for p in status if p > P9["todo"]),
          "phase 9: a task outside the drained priorities got a status other than SKIPPED")

    # 4. The merge with a corrections file derived from the drained todo:
    derived = os.path.join(folder, "todo-corr.sqlite")
    merged = os.path.join(folder, "todo-merged.sqlite")
    shutil.copy(todo, derived)
    changed = next(p for p in drained if status[p] == STATUS.OK.value)
    with sqlite3.connect(derived) as conn:
        conn.execute("ALTER TABLE todolist ADD COLUMN corr_status INTEGER DEFAULT NULL;")
        conn.execute("UPDATE todolist SET corr_status=1;")
        conn.execute("CREATE TABLE diagnostics_corr (priority INTEGER PRIMARY KEY, "
                     "lightcurve TEXT);")
        conn.execute("INSERT INTO diagnostics_corr SELECT priority, 'x.fits' FROM todolist;")
        conn.execute("UPDATE todolist SET status=? WHERE priority=?;",
                     (STATUS.WARNING.value, changed))
    tic = time.perf_counter()
    rc = todo_merge_cmd.main(["-q", todo, derived, merged])
    walls["merge"] = time.perf_counter() - tic
    check(rc == 0, f"phase 9: todo_merge_cmd exited {rc}")
    with sqlite3.connect(merged) as conn:
        corr = dict(conn.execute("SELECT priority, corr_status FROM todolist"))
        left = {p for (p,) in conn.execute("SELECT priority FROM diagnostics_corr")}
    invalid = {p for p, st in status.items() if st is None} | {changed}
    print(f"phase 9 merge: todo_merge_cmd in {walls['merge']:.2f} s: corr_status NULL on "
          f"{sum(v is None for v in corr.values())} rows ({len(invalid) - 1} undrained + the "
          f"changed one), {len(left)} diagnostics_corr rows kept ({card})", flush=True)
    check({p for p, v in corr.items() if v is None} == invalid
          and all(corr[p] == 1 for p in corr if p not in invalid),
          "phase 9: corr_status not invalidated on exactly the undrained and changed rows")
    check(left == set(corr) - invalid, "phase 9: diagnostics_corr rows of invalid rows kept")
    print(f"phase 9 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; todo rows {len(rows_db)} ({card})", flush=True)
    return walls


# --- phase 11: the mesh on one card -----------------------------------------------

MESH_CARD = ["cuda:0"] * 4            # four mesh entries of the one card (JAX's virtual devices)
P11 = {"T_pad": 510, "prep_frames": 32, "sky": 150.0, "drain": 512}


def mesh_results_equal(what, got, want, T_=None):
    """Statuses, masks and every light-curve column of ``got`` equal to
    ``want``'s bit for bit (``want``'s cut to the first ``T_`` cadences).
    Returns the number of light curves compared."""
    keys = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")
    n_lc = 0
    for a, b in zip(want, got):
        check(a.starid == b.starid and a.status == b.status,
              f"{what}: TIC {a.starid} status {b.status} != {a.status}")
        check((a.mask is None) == (b.mask is None)
              and (a.mask is None or np.array_equal(a.mask, b.mask)),
              f"{what}: TIC {a.starid} mask differs")
        for k in keys:
            if k in a.lightcurve:
                ref = a.lightcurve[k] if T_ is None else a.lightcurve[k][:T_]
                check(lc_bits_equal(ref, b.lightcurve[k]), f"{what}: TIC {a.starid} {k} differs")
        n_lc += bool(a.lightcurve)
    check(len(got) == len(want), f"{what}: {len(got)} results, not {len(want)}")
    return n_lc


def mesh_phase(ctx_kw, sids, results3, psf_calls, walls, card):
    """Phase 11 (a)-(d): phase 3's cubes on a mesh of one card, against
    phases 3 and 4 (see the module docstring); returns nothing, fails on a
    mismatch."""
    import torch
    from photometry_tpu_torch.core import engine
    from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, PSF_WARM_FIT
    from photometry_tpu_torch.ops.background import estimate_background
    from photometry_tpu_torch.ops.filters import time_moving_nanmean
    from photometry_tpu_torch.parallel.mesh import ShardedCube, make_mesh
    from photometry_tpu_torch.parallel.sharded import prepare_step, sharded_psf_fit
    names = ("images", "images_err", "backgrounds", "pixelflags")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    print(f"phase 11 mesh: make_mesh(..., {MESH_CARD}) (four entries of the one card); "
          f"{base / 1e9:.1f} GB held before; phase 3's slice {walls['3']:.2f} s (peak "
          f"{walls['3 peak'] / 1e9:.2f} GB above what it held), phase 4's {walls['4']:.2f} s "
          f"({card})", flush=True)

    # (a) time=4 on phase 3's tensors: four views; then T = 510, a padded last shard.
    sharded_calls = []
    run_sharded = engine._extract_flux_sharded

    def seen_sharded(ctx_, *a):
        out = run_sharded(ctx_, *a)
        sharded_calls.append((a, out))
        return out

    for T_ in (T, P11["T_pad"]):
        kw = dict(ctx_kw, mesh=make_mesh(4, 1, MESH_CARD))
        if T_ != T:
            kw.update({k: ctx_kw[k][:T_] for k in names},
                      **{k: ctx_kw[k][:T_] for k in ("time", "timecorr", "cadenceno", "quality")})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tic = time.perf_counter()
        ctx = SectorContext.from_arrays(**kw)
        torch.cuda.synchronize()
        made = time.perf_counter() - tic
        views = [all(c.shards[i].data_ptr() == ctx_kw[k][i * c.frames].data_ptr()
                     for k, c in ((k, getattr(ctx, k)) for k in names)) for i in range(4)]
        check(all(isinstance(getattr(ctx, k), ShardedCube) for k in names)
              and ctx.n_times == T_ and ctx.images.shape[0] == 4 * -(-T_ // 4),
              f"phase 11a: the mesh context's cubes at T={T_} are not time-sharded")
        check(views == [True, True, True, T_ == T],
              f"phase 11a: shards that are views at T={T_}: {views}")
        reset_counts()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        with mock.patch.object(engine, "_extract_flux_sharded", seen_sharded):
            res = extract_aperture_batch(ctx, sids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        peak = torch.cuda.max_memory_allocated() - held
        launches = BAND_EXTRACT.launches
        check(launches == 4, f"phase 11a: {launches} band launches at T={T_}, not 4 (one a shard)")
        n_lc = mesh_results_equal(f"phase 11a T={T_}", res, results3, None if T_ == T else T_)
        layout = ("four views of phase 3's cube" if T_ == T
                  else "three views, the last shard a padded copy")
        print(f"phase 11a time=4 at T={T_} ({layout}): "
              f"context in {made:.3f} s; {len(sids)} targets in {wall:.2f} s = "
              f"{len(sids) / wall:.1f} targets/s ({wall / walls['3']:.2f}x phase 3's wall); band "
              f"kernel launches {launches}; peak {peak / 1e9:.2f} GB above what was held "
              f"({(peak - walls['3 peak']) / 1e9:+.2f} GB against phase 3's); statuses, masks and "
              f"{n_lc} light curves bit-equal to phase 3's ({card})", flush=True)
        ctx.close()
        del ctx, res
    check(len(sharded_calls) == 2, f"phase 11a: {len(sharded_calls)} sharded extractions, not 2")

    # (b) time=2, targets=2: the same targets through _extract_flux_sharded.
    args, want = sharded_calls[0]
    ctx = SectorContext.from_arrays(**dict(ctx_kw, mesh=make_mesh(2, 2, MESH_CARD)))
    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    got = engine._extract_flux_sharded(ctx, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = BAND_EXTRACT.launches
    check(launches == 4, f"phase 11b: {launches} band launches, not 4 (2 x 2 blocks)")
    check(all(bit_equal(a, b) if a.dtype.is_floating_point else torch.equal(a, b)
              for a, b in zip(got, want)), "phase 11b: time=2 x targets=2 differs from time=4")
    print(f"phase 11b time=2 x targets=2: _extract_flux_sharded on the {args[0].shape[0]} final "
          f"masks ({args[0].shape[1]}x{args[0].shape[2]}) in {wall:.3f} s; band kernel launches "
          f"{launches}; the five outputs bit-equal to (a)'s, so to phase 3's ({card})", flush=True)
    ctx.close()
    del ctx, got, want, sharded_calls, args

    # (c) sharded_psf_fit on phase 4's own fit calls, over the flattened 4-entry mesh.
    mesh4 = make_mesh(4, 1, MESH_CARD)
    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    n_equal, n_fused, fracs = 0, 0, []
    for a, out in psf_calls:
        before = PSF_WARM_FIT.launches
        got = sharded_psf_fit(*a[:10], mesh4, a[10] if len(a) > 10 else "Gaussian_d")
        n_fused += PSF_WARM_FIT.launches > before
        if all(bit_equal(got[k], out[k]) for k in out):
            n_equal += 1
            continue
        g, w = got["flux"].cpu().numpy(), out["flux"].cpu().numpy()
        ok = (np.abs(g - w) <= 2e-2 * np.abs(w)) | (np.isnan(g) & np.isnan(w))
        fracs.append(float(ok.mean()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = PSF_WARM_FIT.launches
    n_targets = sum(out["flux"].shape[0] for _, out in psf_calls)
    print(f"phase 11c sharded_psf_fit: phase 4's {len(psf_calls)} fit calls ({n_targets} targets "
          f"with padding) over 4 shards in {wall:.2f} s ({wall / walls['4']:.2f}x phase 4's "
          f"slice); PSF kernel launches {launches} ({n_fused} calls through the kernel, "
          f"{len(psf_calls) - n_fused} plain); {n_equal} of {len(psf_calls)} calls bit-equal "
          f"to phase 4's fit" + (f", the others' flux within 2e-2 for a share of "
                                 f"{min(fracs):.4f} at least" if fracs else "")
          + f" ({card})", flush=True)
    check(launches >= 8, f"phase 11c: {launches} PSF kernel launches over 4 shards")
    check(not fracs or min(fracs) >= 0.99, "phase 11c: the sharded fit differs from phase 4's")
    del psf_calls

    # (d) prepare_step on 32 frames of phase 3's field at time=4, on a sky
    # (phase 3's field has none: its zero-mean noise puts half the pixels
    # below 0, which the background fit excludes).
    frames = ctx_kw["images"][:P11["prep_frames"]] + P11["sky"]
    quality = np.zeros(len(frames), np.int32)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    sub, bkg, s = prepare_step(frames, quality, mesh4, tile=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    tic = time.perf_counter()
    b1 = time_moving_nanmean(estimate_background(frames, tile=64)[0])
    sub1 = frames - b1
    fin = torch.isfinite(sub1)
    s1 = torch.where(fin, sub1, 0.0).sum(dim=0) / torch.clamp(fin.sum(dim=0), min=1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - tic
    bk = bkg.full()
    rel_b = float(((bk - b1).abs() / b1.abs().clamp(min=1e-30)).max())
    d_s = float((s - s1).abs().max())
    lim_s = float((1e-5 * s1.abs() + 1e-5 * b1.abs().amax(dim=0)).min())
    ok_s = bool(((s - s1).abs() <= 1e-5 * s1.abs() + 1e-5 * b1.abs().amax(dim=0)).all())
    print(f"phase 11d prepare_step: {len(frames)} frames of {H}x{W} (phase 3's field on a "
          f"{P11['sky']:g} e-/s sky) at time=4, tile 64, in "
          f"{wall:.2f} s (unsharded estimate_background -> time_moving_nanmean -> sum "
          f"{wall1:.2f} s); backgrounds max relative diff {rel_b:.3g} (bound 1e-5), sum image "
          f"max |diff| {d_s:.3g} (bound 1e-5 of it plus 1e-5 of the background) ({card})",
          flush=True)
    check(rel_b <= 1e-5 and ok_s, f"phase 11d: prepare_step off the unsharded path "
          f"(background {rel_b:.3g}, sum image {d_s:.3g}, tightest limit {lim_s:.3g})")
    del sub, bkg, s, b1, sub1, s1, bk, frames
    torch.cuda.empty_cache()


def mesh_drain(drained, dev, card):
    """Phase 11 (e): phase 7's first P11["drain"] tasks drained again with
    and without a (time=2, targets=2) mesh of the card, the mesh passed to
    ``run_drain`` and on through ``open_context``: per task the same status
    and method, FLUX_RAW bit for bit."""
    import torch
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    from photometry_tpu_torch.core.engine import SectorContext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    from photometry_tpu_torch.parallel.mesh import make_mesh
    ctx_kw, todo, tmags, folder = drained["ctx_kw"], drained["todo"], drained["tmags"], \
        drained["folder"]
    n = P11["drain"]
    out = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh(2, 2, MESH_CARD))):
        sub = os.path.join(folder, f"phase11-{name}")
        os.makedirs(sub)
        write_todo(sub, todo[:n], tmags[:n])
        seen = []

        def opened(input_folder, task, cache="device", device=None, mesh=None):
            seen.append(mesh)
            return SectorContext.from_arrays(**ctx_kw, mesh=mesh)

        timers = new_timers()
        reset_counts()
        with mock.patch.object(dispatcher, "open_context", opened):
            done = run_drain(sub, 1, method=None, batch_size=256, timers=timers, device=dev,
                             mesh=mesh)
        torch.cuda.synchronize()
        check(seen and all(m is mesh for m in seen),
              f"phase 11e: run_drain did not hand its mesh to open_context: {seen}")
        out[name] = (read_drain(sub)[0], done, timers["wall"], BAND_EXTRACT.launches)
    (got, n_m, wall_m, bl_m), (want, n_p, wall_p, bl_p) = out["mesh"], out["plain"]
    check(set(got) == set(want), "phase 11e: the two drains hold other tasks")
    diff = [p for p in want if got[p][1:3] != want[p][1:3]
            or (want[p][3] is None) != (got[p][3] is None)
            or (want[p][3] is not None and not lc_bits_equal(got[p][3], want[p][3]))]
    n_lc = sum(v[3] is not None for v in want.values())
    methods = [v[2] for v in want.values()]
    print(f"phase 11e drain: {n} of phase 7's tasks (methods "
          + ", ".join(f"{m} {methods.count(m)}" for m in sorted(set(map(str, methods))))
          + f"): run_drain with a time=2 x targets=2 mesh {n_m} tasks in {wall_m:.2f} s (band "
          f"launches {bl_m}), without {n_p} in {wall_p:.2f} s (band launches {bl_p}); "
          f"{len(want) - len(diff)} of {len(want)} tasks the same status and method, {n_lc} "
          f"FLUX_RAW compared bit for bit ({card})", flush=True)
    check(not diff, f"phase 11e: {len(diff)} tasks differ with a mesh: {diff[:5]}")
    check(bl_m == 4 * bl_p and bl_p > 0,
          f"phase 11e: {bl_m} band launches with the mesh, {bl_p} without (want 4x)")


def nccl_phase(card):
    """Phase 11 (f): a one-process NCCL group on the card: initialize,
    global_mesh over four entries of the card, local_data_slice, a sharded
    sum through the group's all_gather, shutdown (the card's counterpart
    of tests/test_multihost.py:170-184)."""
    import socket
    import torch
    from photometry_tpu_torch.parallel import multihost
    from photometry_tpu_torch.parallel.mesh import shard_cube
    from photometry_tpu_torch.parallel.sharded import sharded_sumimage
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tic = time.perf_counter()
    pid = multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                               device="cuda", timeout=120)
    import torch.distributed as dist
    backend = dist.get_backend()
    mesh = multihost.global_mesh(n_targets=2, devices=MESH_CARD)
    sl = multihost.local_data_slice(8, mesh)
    x = shard_cube(torch.arange(8.0, device="cuda").reshape(8, 1, 1), mesh)
    total = float(sharded_sumimage(x, np.ones(8, bool), mesh)[0, 0] * 8)
    multihost.shutdown()
    wall = time.perf_counter() - tic
    print(f"phase 11f NCCL: initialize -> process {pid} of 1 ({backend}), global_mesh "
          f"{mesh.shape}, local_data_slice(8) {sl}, sharded sum of arange(8) = {total:g}, "
          f"shutdown; {wall:.2f} s ({card})", flush=True)
    check(pid == 0 and backend == "nccl" and mesh.shape == {"time": 2, "targets": 2}
          and sl == slice(0, 8) and total == 28.0 and not multihost.is_initialized(),
          "phase 11f: the one-process NCCL smoke failed")


# --- phase 10: several workers drain one todo list; diagnostics -------------------

def field_wcs():
    """The TAN WCS of the seeded field (phases 3, 7 and 10)."""
    from photometry_tpu_torch.io.wcs import TanWCS
    return TanWCS(crpix=[W / 2 + 0.5, H / 2 + 0.5], crval=[95.0, -60.0],
                  cd=[[-21.0 / 3600, 0.0], [0.0, 21.0 / 3600]])


def phase10_sector(dev, seed):
    """Phase 10's phase-7-like sector, rebuilt on ``dev`` from ``seed`` alone:
    ``make_field``, ``make_cubes``, ``phase7_layout``, ``renoise_phase7`` and
    ``inject_phase7`` each draw from a generator of their own, so every
    process that calls this holds the same cube bit for bit.  Returns the
    cubes, every star's row, column and Tmag (the field, then the bright
    stars, then the pairs), the bright stars', the pairs' and the field's
    starids, and the phase-7 todo list of P7["todo"] starids (those three
    in turn)."""
    import torch
    rows, cols, tmag, img0 = make_field(np.random.default_rng([seed, 10, 1]))
    gens = []
    for k in range(3):
        gens.append(torch.Generator(device=dev))
        gens[-1].manual_seed(1_000_003 * seed + 10 + k)
    images, errs, bkgs, flags = make_cubes(img0, gens[0], dev)
    lay = phase7_layout(np.random.default_rng([seed, 10, 2]), rows, cols, tmag, H, W)
    renoise_phase7(images, errs, img0, gens[1])
    inject_phase7(images, errs, lay, gens[2])
    nb, n0 = len(lay["b_tmag"]), len(rows)
    all_tmag = np.concatenate([tmag, lay["b_tmag"], lay["p_tmag"]])
    sids = np.arange(1, len(all_tmag) + 1)
    field = [int(s) for s in np.argsort(tmag, kind="stable")
             [:P7["todo"] - nb - len(lay["p_tmag"])] + 1]
    b_sids = [int(s) for s in sids[n0:n0 + nb]]
    p_sids = [int(s) for s in sids[n0 + nb:]]
    return {"cubes": (images, errs, bkgs, flags),
            "rows": np.concatenate([rows, lay["b_rows"], lay["p_rows"]]),
            "cols": np.concatenate([cols, lay["b_cols"], lay["p_cols"]]),
            "tmag": all_tmag, "b_sids": b_sids, "p_sids": p_sids, "field": field,
            "todo": b_sids + p_sids + field}


def phase10_folder(folder, sec, todo):
    """A drain's folder: the sector's catalog and a todo.sqlite of ``todo``."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    os.makedirs(folder)
    ra, dec = field_wcs().radec_of_rowcol(sec["rows"], sec["cols"])
    n = len(sec["tmag"])
    make_catalog_from_arrays(folder, 1, 1, 1, starid=np.arange(1, n + 1), ra_j2000=ra,
                             dec_j2000=dec, pm_ra=np.zeros(n), pm_dec=np.zeros(n),
                             tmag=sec["tmag"], reference_time=2458340.0)
    write_todo(folder, todo, sec["tmag"][np.array(todo) - 1])
    return folder


def frame_nanmean(images, chunk=64):
    """The mean over frames of an (T, H, W) cube, NaN left out, ``chunk``
    frames at a time: ``torch.nanmean`` over the whole cube takes a
    temporary as large as the cube, which two workers' cubes leave no room
    for on one card."""
    import torch
    total = torch.zeros(images.shape[1:], device=images.device)
    count = torch.zeros(images.shape[1:], device=images.device)
    for t0 in range(0, images.shape[0], chunk):
        block = images[t0:t0 + chunk]
        nan = torch.isnan(block)
        total += torch.where(nan, 0.0, block).sum(dim=0)
        count += (~nan).sum(dim=0)
    return (total / count).cpu().numpy()


def phase10_context(folder, sec, dev):
    """``SectorContext.from_arrays`` over the sector's cubes, its catalog in ``folder``."""
    from photometry_tpu_torch.catalog import catalog_filename
    from photometry_tpu_torch.core.engine import SectorContext
    images, errs, bkgs, flags = sec["cubes"]
    T_ = images.shape[0]
    return SectorContext.from_arrays(
        images=images, images_err=errs, backgrounds=bkgs, pixelflags=flags,
        sumimage=frame_nanmean(images),
        time=1325.3 + np.arange(T_) / 48.0, timecorr=np.zeros(T_, np.float32),
        cadenceno=np.arange(T_, dtype=np.int32), quality=np.zeros(T_, np.int32),
        catalog_path=os.path.join(folder, catalog_filename(1, 1, 1)), wcs=field_wcs(),
        sector=1, camera=1, ccd=1, header={"PSFSIGMA": 1.2}, input_folder=folder,
        device=dev)


def phase10_worker(port, folder, seed, device, sizes):
    """A TCP worker of phase 10(b), in a process of its own: the import
    blocker, phase 10's sector rebuilt on the card from ``seed``, handed
    back by ``dispatcher.open_context``, then ``scheduler.worker_remote``.
    At exit it writes its band-kernel launches, peak device memory and the
    wall of its drain to ``<folder>/worker-<pid>.json``."""
    import torch
    globals().update(sizes)
    sys.path.insert(0, HERE)
    sys.meta_path.insert(0, _Blocked())
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    from photometry_tpu_torch.parallel import scheduler
    dev = torch.device(device)
    sec = phase10_sector(dev, seed)
    ctx = phase10_context(folder, sec, dev)
    dispatcher.open_context = lambda *a, **k: ctx
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    scheduler.worker_remote(("127.0.0.1", port), folder, version=1, device=dev,
                            connect_timeout=600.0)
    t1 = time.time()
    blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "h5py",
                                                            "photometry_tpu")]
    with open(os.path.join(folder, f"worker-{os.getpid()}.json"), "w") as fh:
        json.dump({"launches": BAND_EXTRACT.launches, "t0": t0, "t1": t1, "blocked": blocked,
                   "peak": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0},
                  fh)


def read_drain(folder):
    """{priority: (starid, status, method or None, FLUX_RAW or None)} of a
    drained folder; the products read on a thread pool."""
    import sqlite3
    from concurrent.futures import ThreadPoolExecutor
    from photometry_tpu_torch.io import fits as pf
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        rows = conn.execute(
            "SELECT t.priority, t.starid, t.status, d.method_used, d.lightcurve FROM todolist t "
            "LEFT JOIN diagnostics d ON t.priority = d.priority").fetchall()
        dup = conn.execute("SELECT COUNT(*) FROM (SELECT priority FROM diagnostics "
                           "GROUP BY priority HAVING COUNT(*) > 1)").fetchone()[0]
        skipped = {p for p, in conn.execute("SELECT priority FROM photometry_skipped")}

    def flux(path):
        if not path:
            return None
        return np.asarray(pf.read_fits(os.path.join(folder, path))[1].data["FLUX_RAW"])

    with ThreadPoolExecutor(8) as pool:
        fluxes = list(pool.map(flux, [r[4] for r in rows]))
    check(dup == 0, f"{folder}: a priority has more than one diagnostics row")
    return {p: (sid, st, m, f) for (p, sid, st, m, _), f in zip(rows, fluxes)}, skipped


def compare_drains(what, got, want, strict):
    """Per task the same status, and for tasks run in both the same method
    and FLUX_RAW: bit for bit, else within ROADMAP's tolerances (aperture
    RTOL/ATOL, linPSF rtol 1e-4, halo rtol 5e-4).  With ``strict`` the
    statuses must be equal; without, tasks SKIPPED in one run only are
    counted.  Also: no task both run and SKIPPED (its status OK, WARNING or
    ERROR while photometry_skipped names it).  Returns a summary line."""
    from photometry_tpu_torch.core.status import STATUS
    (g, g_skipped), (w, _) = got, want
    final = {STATUS.OK.value, STATUS.WARNING.value, STATUS.ERROR.value, STATUS.SKIPPED.value}
    check(set(g) == set(w) and all(v[1] in final for v in g.values()),
          f"{what}: a task has no final status")
    run = (STATUS.OK.value, STATUS.WARNING.value, STATUS.ERROR.value)
    both = sorted(p for p in g if g[p][1] in run and w[p][1] in run)
    skip_diff = sum((g[p][1] == STATUS.SKIPPED.value) != (w[p][1] == STATUS.SKIPPED.value)
                    for p in g)
    other_diff = sum(g[p][1] != w[p][1] for p in g) - skip_diff
    run_and_skipped = sum(g[p][1] in run for p in g_skipped)
    tol = {"aperture": (RTOL, ATOL), "linpsf": (1e-4, 0.0), "halo": (5e-4, 0.0)}
    methods_differ, bit_equal, within, worst = 0, 0, 0, 0.0
    for p in both:
        (_, _, mg, fg), (_, _, mw, fw) = g[p], w[p]
        if mg != mw:
            methods_differ += 1
            continue
        if fg is None or fw is None:
            check(fg is None and fw is None, f"{what}: priority {p} has a product in one run only")
            continue
        if np.array_equal(fg.view(np.uint32), fw.view(np.uint32)):
            bit_equal += 1
            continue
        rtol, atol = tol.get(mg, (RTOL, ATOL))
        ok = np.isnan(fg) == np.isnan(fw)
        fin = ~np.isnan(fw)
        d = np.abs(fg[fin] - fw[fin])
        ok = bool(ok.all() and np.all(d <= atol + rtol * np.abs(fw[fin])))
        check(ok, f"{what}: priority {p} ({mg}) FLUX_RAW off by up to {d.max():.3g}")
        within += 1
        worst = max(worst, float(d.max()) if d.size else 0.0)
    check(methods_differ == 0, f"{what}: {methods_differ} tasks ran another method")
    check(other_diff == 0, f"{what}: {other_diff} tasks end in another status (not SKIPPED)")
    check(not strict or skip_diff == 0, f"{what}: {skip_diff} tasks SKIPPED in one run only")
    check(run_and_skipped == 0, f"{what}: {run_and_skipped} tasks both run and SKIPPED")
    return (f"{len(both)} tasks run in both: the same methods, FLUX_RAW bit-equal {bit_equal}, "
            f"within the tolerances {within} (max |diff| {worst:.3g}); {skip_diff} tasks "
            f"SKIPPED in one run only; none both run and SKIPPED")


def phase10_tpf(work, p8_folder, dev, card):
    """Phase 10(a): ``cli/scheduler_cmd`` with two local workers over pipes on
    a todo of P10["tpf"] of phase 8's primary TPFs and their secondaries;
    the workers open the TPFs through the real ``open_context``."""
    import contextlib
    import io
    import shutil
    import sqlite3
    from photometry_tpu_torch.catalog import catalog_filename
    from photometry_tpu_torch.cli import scheduler_cmd
    folder = os.path.join(work, "phase10a")
    os.makedirs(folder)
    src = os.path.join(p8_folder, "todo.sqlite")
    with sqlite3.connect(src) as conn:
        prim = conn.execute("SELECT starid, cadence FROM todolist WHERE datasource='tpf' "
                            "ORDER BY priority LIMIT ?", (P10["tpf"],)).fetchall()
    shutil.copy(src, os.path.join(folder, "todo.sqlite"))
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        keep = [p for sid, cad in prim for p, in conn.execute(
            "SELECT priority FROM todolist WHERE cadence=? AND (datasource=? OR "
            "(datasource='tpf' AND starid=?))", (cad, f"tpf:{sid}", sid))]
        conn.execute(f"DELETE FROM todolist WHERE priority NOT IN ({','.join('?' * len(keep))})",
                     keep)
        conn.execute("UPDATE todolist SET status=NULL")
        conn.execute("DROP TABLE IF EXISTS diagnostics")
        conn.execute("DROP TABLE IF EXISTS photometry_skipped")
        n_tasks = conn.execute("SELECT COUNT(*) FROM todolist").fetchone()[0]
    shutil.copy(os.path.join(p8_folder, catalog_filename(1, 1, 1)), folder)
    n_files = 0
    for name in os.listdir(p8_folder):
        if "tp.fits" in name and any(f"{sid:016d}" in name and ("fast-" in name) == (cad == 20)
                                 for sid, cad in prim):
            os.symlink(os.path.join(p8_folder, name), os.path.join(folder, name))
            n_files += 1
    check(n_files == len(prim), f"phase 10(a): {n_files} TPF files for {len(prim)} primaries")
    out = io.StringIO()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = scheduler_cmd.main(["-q", "--workers", "2", "--datasource", "tpf", "--version",
                                 "1", "--device", str(dev), folder])
    wall = time.perf_counter() - tic
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and summary["drained"] is True,
          f"phase 10(a): scheduler_cmd exited {rc}, drained {summary.get('drained')}")
    got = read_drain(folder)
    want, _ = read_drain(p8_folder)
    want = {p: v for p, v in want.items() if p in got[0]}
    line = compare_drains("phase 10(a)", got, (want, None), strict=True)
    n_prod = sum(v[3] is not None for v in got[0].values())
    print(f"phase 10(a) scheduler_cmd --workers 2 --datasource tpf: {n_tasks} tasks "
          f"({len(prim)} primary TPFs of phase 8 and their secondaries) in {wall:.2f} s = "
          f"{n_tasks / wall:.2f} tasks/s with {n_prod} products, the workers' start included "
          f"({card}); exit 0, drained, every task final, one diagnostics row each; against "
          f"phase 8's run_drain: {line}", flush=True)
    return {"wall": wall, "n": n_tasks}


def phase10_debug(ctx, sids, card):
    """Phase 10(c), first part: the K2P2 debug images of P10["debug"] targets
    on the card against the same call on the CPU (above, labels, seg and
    mask exact; blurred within tests/test_torch_k2p2.py's blur tolerance)."""
    from photometry_tpu_torch.core.engine import extract_aperture_batch
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.diagnostics import k2p2_debug
    res = [r for r in extract_aperture_batch(ctx, sids[:2 * P10["debug"]])
           if r.status in (STATUS.OK, STATUS.WARNING) and r.stamp is not None][:P10["debug"]]
    check(len(res) == P10["debug"], f"phase 10(c): {len(res)} aperture results to debug")
    tic = time.perf_counter()
    worst, shapes = 0.0, set()
    for r in res:
        got, want = k2p2_debug(r, ctx), k2p2_debug(r, ctx, device="cpu")
        for key in ("above", "labels", "seg", "mask"):
            check(np.array_equal(got[key], want[key]),
                  f"phase 10(c): TIC {r.starid}'s K2P2 {key} differs between card and CPU")
        check(np.allclose(got["blurred"], want["blurred"], rtol=1e-5, atol=1e-3),
              f"phase 10(c): TIC {r.starid}'s blurred flux differs between card and CPU")
        check(np.array_equal(got["mask"], r.mask), f"phase 10(c): TIC {r.starid}'s debug "
              "mask differs from its aperture mask")
        worst = max(worst, float(np.abs(got["blurred"] - want["blurred"]).max()))
        shapes.add(got["seg"].shape)
    ctx.close()
    print(f"phase 10(c) K2P2 debug: {len(res)} stamps ({sorted(shapes)}) on the card == on the "
          f"CPU: above, labels, seg and mask equal (and the mask the aperture pass's), "
          f"blurred max |diff| {worst:.3g}; {time.perf_counter() - tic:.2f} s ({card})",
          flush=True)


def phase10_plots(work, sec, dev, card):
    """Phase 10(c), second part: ``run_drain(plot=True)`` over P10["plot"]
    tasks with one bright star (halo switch) and one pair (deblend switch):
    every OK aperture task's sumimage and masks_flux, the linPSF ones'
    psf_fit, the halo one's weight maps."""
    from photometry_tpu_torch import diagnostics
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    from photometry_tpu_torch.core.status import STATUS
    todo = [sec["b_sids"][0]] + sec["p_sids"][:2] + sec["field"][:P10["plot"] - 3]
    folder = phase10_folder(os.path.join(work, "phase10c"), sec, todo)
    ctx = phase10_context(folder, sec, dev)
    plot_wall = [0.0]
    run_plot = diagnostics.plot_target_diagnostics

    def timed_plot(res, ctx_, base):
        tic_ = time.perf_counter()
        out = run_plot(res, ctx_, base)
        plot_wall[0] += time.perf_counter() - tic_
        return out

    timers = new_timers()
    with mock.patch.object(dispatcher, "open_context", lambda *a, **k: ctx), \
            mock.patch.object(diagnostics, "plot_target_diagnostics", timed_plot):
        n_done = run_drain(folder, 1, method=None, batch_size=P10["batch"], plot=True,
                           timers=timers, device=dev)
    got, _ = read_drain(folder)
    methods = {}
    for sid, st, m, _ in got.values():
        if st in (STATUS.OK.value, STATUS.WARNING.value):
            methods[sid] = m
    n_fig = 0
    for sid, m in methods.items():
        figs = set(os.listdir(diagnostics.target_plot_folder(folder, sid)))
        want = {"sumimage.png"} | ({"masks_flux.png"} if m == "aperture" else set()) \
            | ({"psf_fit.png"} if m == "linpsf" else set())
        check(want <= figs, f"phase 10(c): TIC {sid} ({m}) lacks {sorted(want - figs)}")
        if m == "halo":
            check(any(f.startswith(f"{sid}_weightmap_") for f in figs),
                  f"phase 10(c): the halo star {sid} has no weight map")
        n_fig += len(figs)
    b, p = sec["b_sids"][0], sec["p_sids"][:2]
    check(methods.get(b) == "halo", f"phase 10(c): the bright star ran {methods.get(b)}")
    check([methods.get(s) for s in p] == ["linpsf", "linpsf"],
          f"phase 10(c): the pair ran {[methods.get(s) for s in p]}")
    t = timers
    print(f"phase 10(c) plots: run_drain(plot=True) of {n_done} tasks (one halo star, one "
          f"linPSF pair) in {t['wall']:.2f} s, of which the figures {plot_wall[0]:.2f} s "
          f"(photometry {t['photometry']:.2f} s, save {t['save']:.2f} s); {n_fig} figures for "
          f"{len(methods)} OK/WARNING tasks, each with the JAX package's set ({card})",
          flush=True)
    ctx.close()


def scheduler_phase(work, p8_folder, seed, dev, card):
    """Phase 10 (see the module docstring).  Returns the tasks/s it printed."""
    import multiprocessing
    import shutil
    import socket
    import torch
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    from photometry_tpu_torch.parallel.scheduler import run_distributed
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        print(f"phase 10 start: torch.cuda.memory_allocated() {torch.cuda.memory_allocated()} "
              f"bytes, reserved {torch.cuda.memory_reserved()}", flush=True)
    phase10_tpf(work, p8_folder, dev, card)

    # (b) the reference: run_drain in this process on the same seeded sector.
    tic = time.perf_counter()
    sec = phase10_sector(dev, seed)
    if on_card:
        torch.cuda.synchronize()
    made = time.perf_counter() - tic
    folders = {name: phase10_folder(os.path.join(work, f"phase10b-{name}"), sec, sec["todo"])
               for name in ("drain", "N1", "N2")}
    ctx = phase10_context(folders["drain"], sec, dev)
    timers = new_timers()
    reset_counts()
    with mock.patch.object(dispatcher, "open_context", lambda *a, **k: ctx):
        n_ref = run_drain(folders["drain"], 1, method=None, batch_size=P10["batch"],
                          timers=timers, device=dev)
    ref_launches = BAND_EXTRACT.launches
    check(ref_launches > 0, "phase 10(b): the reference drain did not launch the band kernel")
    rates = {"run_drain": n_ref / timers["wall"]}
    print(f"phase 10(b) reference: the seeded sector ({T}, {H}, {W}) x4 made on the card in "
          f"{made:.1f} s; run_drain of {n_ref} tasks in {timers['wall']:.2f} s = "
          f"{rates['run_drain']:.1f} tasks/s with products (photometry "
          f"{timers['photometry']:.2f} s, save {timers['save']:.2f} s), band kernel launches "
          f"{ref_launches} ({card})", flush=True)
    phase10_debug(phase10_context(folders["drain"], sec, dev), sec["p_sids"][:4] + sec["field"],
                  card)
    tools = {m: (getattr(__import__(m), "__version__", "?")
                 if importlib.util.find_spec(m) is not None else None)
             for m in ("matplotlib", "PIL")}
    print(f"phase 10(c) figure tools here: matplotlib {tools['matplotlib'] or 'not installed'}, "
          f"Pillow {tools['PIL'] or 'not installed'}, ffmpeg "
          f"{shutil.which('ffmpeg') or 'not on PATH'}", flush=True)
    if tools["matplotlib"] is None:
        print("phase 10(c) plots: without matplotlib the figures are not drawn", flush=True)
    else:
        phase10_plots(work, sec, dev, card)
    del ctx, sec
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = read_drain(folders["drain"])

    # N = 1 and 2 TCP workers, each holding its own copy of the sector.
    mp = multiprocessing.get_context("spawn")
    sizes = {"H": H, "W": W, "T": T, "N_STARS": N_STARS, "P7": P7}
    for n in (1, 2):
        folder = folders[f"N{n}"]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [mp.Process(target=phase10_worker, args=(port, folder, seed, str(dev), sizes))
                 for _ in range(n)]
        tic = time.perf_counter()
        for proc in procs:
            proc.start()
        done = threading.Event()

        def watchdog():
            """The master waits in accept() for every worker: one that dies
            before it connects would hang the run, so the run ends here."""
            while not done.wait(1.0):
                codes = [proc.exitcode for proc in procs]
                if any(c not in (None, 0) for c in codes):
                    print(f"FAIL: phase 10(b) N={n}: worker exit codes {codes}", flush=True)
                    for proc in procs:
                        if proc.is_alive():
                            proc.terminate()
                    os._exit(1)

        threading.Thread(target=watchdog, daemon=True).start()
        try:
            summary = run_distributed(folder, n_workers=n, version=1, batch_size=P10["batch"],
                                      device=dev, listen=("127.0.0.1", port))
        finally:
            done.set()
            for proc in procs:
                proc.join(timeout=120)
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        total = time.perf_counter() - tic
        check(all(proc.exitcode == 0 for proc in procs),
              f"phase 10(b) N={n}: worker exit codes {[proc.exitcode for proc in procs]}")
        check(summary["drained"] is True, f"phase 10(b) N={n}: the queue was not drained")
        stats = []
        for name in sorted(os.listdir(folder)):
            if name.startswith("worker-"):
                with open(os.path.join(folder, name)) as fh:
                    stats.append(json.load(fh))
        check(len(stats) == n, f"phase 10(b) N={n}: {len(stats)} worker reports")
        check(all(st["launches"] > 0 for st in stats),
              f"phase 10(b) N={n}: a worker did not launch the band kernel: "
              f"{[st['launches'] for st in stats]}")
        check(not any(st["blocked"] for st in stats), f"phase 10(b) N={n}: a worker imported "
              f"{[st['blocked'] for st in stats]}")
        wall = max(st["t1"] for st in stats) - max(st["t0"] for st in stats)
        got = read_drain(folder)
        n_done = sum(v[2] is not None for v in got[0].values())
        rates[f"N={n}"] = n_done / wall
        line = compare_drains(f"phase 10(b) N={n}", got, ref, strict=False)
        print(f"phase 10(b) N={n} TCP workers: {n_done} tasks drained in {wall:.2f} s (from "
              f"the last worker's connect to the last BYE; {total:.1f} s with the workers' "
              f"start and cubes) = {rates[f'N={n}']:.1f} tasks/s with products; band kernel "
              f"launches per worker {[st['launches'] for st in stats]}, peak device memory "
              f"per worker {[round(st['peak'] / 1e9, 2) for st in stats]} GB ({card}); "
              f"against run_drain: {line}", flush=True)
    print(f"phase 10(b) tasks/s with products: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items())
          + f"; N=2 / N=1 {rates['N=2'] / rates['N=1']:.2f}, N=1 / run_drain "
          f"{rates['N=1'] / rates['run_drain']:.2f} ({card})", flush=True)
    shutil.rmtree(os.path.join(work, "phase10c"), ignore_errors=True)
    return rates


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "photometry_tpu_torch")):
        print("photometry_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    present = {m: importlib.util.find_spec(m) is not None for m in ("jax", "h5py", "photometry_tpu")}
    sys.meta_path.insert(0, _Blocked())
    print(f"phase 0 imports: jax, h5py and photometry_tpu blocked (installed here: {present})",
          flush=True)
    t_start = time.perf_counter()
    laps = [("0", t_start)]

    def lap(phase):
        """Close the wall of ``phase``: the seconds since the last lap."""
        laps.append((phase, time.perf_counter()))

    from photometry_tpu_torch.core.dispatcher import photometry_batch
    from photometry_tpu_torch.core.engine import (_full_catalog_positions, extract_aperture_batch,
                                                  extract_flux_core)
    from photometry_tpu_torch.core.status import STATUS
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.models import psf_fit
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.models.psf_common import bucket_psf_groups, setup_psf_target
    from photometry_tpu_torch.models.psf_fused import (fused_ok, fused_warm_fit_cuda,
                                                       fused_warm_fit_plain)
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import (BAND_EXTRACT, LIBRARIES, MEDIAN15,
                                                   PSF_WARM_FIT, SEGMENT_HIST, STAMP_FLUX,
                                                   build_all)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    tic = time.perf_counter()
    build_all()
    print(f"phase 1 build: {len(LIBRARIES)} kernels -> sm_90a in "
          f"{time.perf_counter() - tic:.1f} s ("
          + ", ".join(f"{lib.name} {lib.build_seconds:.1f} s" for lib in LIBRARIES) + ")",
          flush=True)
    print(f"phase 1 psf_warm_fit<S,K> registers/spill stores: "
          f"{ptxas_summary(PSF_WARM_FIT.build_log)}", flush=True)
    print("phase 1 registers/spill stores: "
          + ptxas_regs(BAND_EXTRACT.build_log + MEDIAN15.build_log + SEGMENT_HIST.build_log
                       + STAMP_FLUX.build_log,
                       ("band_extract_kernelIf", "band_extract_kernelI13__nv_bfloat16",
                        "median15_kernel", "segment_hist_kernel", "to_float_kernel",
                        "stamp_flux_kernel")), flush=True)
    lap("1")
    result = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "library_ms": None} for name, (src, rep) in KERNELS.items()}

    # --- phase 2: band kernel vs plain ------------------------------------
    rng = np.random.default_rng(args.seed)
    arrs = adversarial_inputs(rng)
    t_args = [torch.as_tensor(a, device=dev) for a in arrs]
    h, w = arrs[4].shape[1:]
    win = torch.zeros_like(t_args[4])
    win[:, 1:-1, 2:] = True
    for windows in (None, win):
        got = host(bandext.band_extract_flux_batch(*t_args, h, w, windows=windows))
        want = host(extract_flux_core(*t_args, h, w, windows=windows))
        err = max_err(got, want, "adversarial")
    print(f"phase 2 adversarial: kernel == plain (max |diff| {err:.3g})", flush=True)
    err = max(err, band_adversarial(dev, np.random.default_rng([args.seed, 6])))
    err16 = bf16_adversarial(dev, np.random.default_rng([args.seed, 8]))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # The phases this script gained later draw from generators of their own,
    # so that the earlier phases' data stay as they were:
    seeds = {name: args.seed + 1000 * k
             for k, name in enumerate(("2 TPF shapes", "8", "3b sector"), start=1)}
    gens = {}
    for name, seed in seeds.items():
        gens[name] = torch.Generator(device=dev)
        gens[name].manual_seed(seed)
    tpf_err = band_tpf_shapes(dev, gens["2 TPF shapes"])
    err, err16 = max(err, tpf_err), max(err16, tpf_err)
    rows, cols, tmag, img0 = make_field(rng)
    tic = time.perf_counter()
    images, errs, bkgs, flags = make_cubes(img0, gen, dev)
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in (images, errs, bkgs, flags)) / 1e9
    print(f"phase 3 cubes: ({T}, {H}, {W}) x4 on the card, {gb:.1f} GB, made in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)

    kern_ms, plain_ms, main_err, band_bound, shapes = {}, {}, 0.0, {}, {}
    for hw in (17, 33):
        r0s = rng.integers(0, H - hw, N_PLAIN).astype(np.int32)
        c0s = rng.integers(0, W - hw, N_PLAIN).astype(np.int32)
        r0s[:64] = (np.arange(64) * 64 + 56) % (H - hw)        # straddling cell edges
        c0s[:64] = (np.arange(64) * 128 + 120) % (W - hw)
        masks = rng.uniform(size=(N_PLAIN, hw, hw)) < 0.3
        m_args = [torch.as_tensor(a, device=dev) for a in (masks, r0s, c0s)]
        shapes[hw] = (masks, r0s, c0s, m_args)
        cube = (images, errs, bkgs, flags)

        def kern():
            return bandext.band_extract_flux_batch(*cube, *m_args, hw, hw)

        def plain():
            return extract_flux_core(*cube, *m_args, hw, hw)

        main_err = max(main_err, max_err(host(kern()), host(plain()), f"main shape {hw}x{hw}"))
        sums = bandext.band_sums_cuda(*cube, *m_args)
        check(torch.equal(sums.view(torch.int32),
                          bandext.band_sums_cuda(*cube, *m_args).view(torch.int32)),
              f"band main shape {hw}x{hw}: two runs differ")
        main_err = max(main_err, band_sums_err(sums, bandext.band_sums_plain(*cube, *m_args),
                                               f"band sums main shape {hw}x{hw}"))
        launch, _ = band_launcher(cube, *m_args)
        alone = cuda_ms(launch)
        wrapped = cuda_ms(lambda: bandext.band_sums_cuda(*cube, *m_args))
        kern_ms[hw], plain_ms[hw] = cuda_ms(kern), cuda_ms(plain)
        band_bound[hw] = band_bytes(masks, T) / PEAK_BYTES * 1e3
        sector = band_sector_bytes(masks, r0s, c0s, T, W) / PEAK_BYTES * 1e3
        print(f"phase 2 main shape ({T}, {H}, {W}), {N_PLAIN} targets {hw}x{hw}: "
              f"band_extract_flux_batch {kern_ms[hw]:.3f} ms (band_sums_cuda {wrapped:.3f}, the "
              f"kernel alone {alone:.3f}), plain {plain_ms[hw]:.3f} ms (median of 5), bound "
              f"{band_bound[hw]:.3f} ms by bytes, {sector:.3f} ms by 32-byte sectors; sums "
              f"== plain (counts exact), two runs bit-equal ({card})", flush=True)
    result["band_extract"].update(max_abs_err=max(err, main_err), ms=kern_ms[17],
                                  plain_ms=plain_ms[17], bound_ms=band_bound[17],
                                  bound_by="bytes")
    bf16_main(shapes, (images, errs, bkgs, flags), card, result, err16)
    lap("2")

    # --- phase 2b: PSF kernel vs plain -------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    prfs = {K: table_prf(PRF, work, K, dev) for K in (1, 3, 4)}

    def psf_pair(inputs, prf, S, n_iters):
        ins = [torch.as_tensor(a, device=dev) for a in inputs]
        h_, w_ = inputs[0].shape[1:]
        got = fused_warm_fit_cuda(ins[0], ins[1], 1.0, *ins[2:], prf, (h_, w_), S, n_iters)
        torch.cuda.synchronize()
        want = fused_warm_fit_plain(ins[0], ins[1], 1.0, *ins[2:], prf, (h_, w_), S, n_iters)
        return got, want

    psf_err = 0.0
    rng_test = np.random.default_rng(PSF_TEST_SEED)
    for S, n_iters, B in ((3, 1, 24), (3, 4, 24), (6, 4, 8)):
        inputs = psf_jaxtest_problem(rng_test, prfs[1], B, S)
        got, want = psf_pair(inputs, prfs[1], S, n_iters)
        psf_err = max(psf_err, psf_fit_check(got, want, inputs[3], S,
                                             "tight" if S == 3 else "crowded",
                                             f"test_psf_pallas problem S={S} it={n_iters}"))
    rng_fit = np.random.default_rng([args.seed, 2])
    # Each case is one the plain fitter itself solves stably in float32: its
    # float32 and float64 versions agree well inside the crowded bounds on
    # these draws.  Heavier ones (8 blended stars, or 12 iterations at S=8)
    # part the plain fitter's own two precisions by more than the bounds, so
    # they cannot hold a kernel to them.
    cases = [  # S, K, side, n_iters, B, NaN fraction, blend
        (1, 1, 11, 12, 256, 0.0, False), (3, 1, 11, 12, 512, 0.02, False),
        (5, 3, 15, 6, 2048, 0.01, False), (5, 3, 17, 12, 1024, 0.0, False),
        (3, 3, 15, 6, 512, 0.0, True), (8, 1, 15, 6, 512, 0.0, False),
        (8, 3, 32, 6, 256, 0.01, False), (6, 4, 17, 6, 512, 0.01, False),
        (5, 4, 15, 0, 256, 0.0, False)]
    for S, K, side, n_iters, B, nan_frac, blend in cases:
        inputs = psf_instances(rng_fit, prfs[K], B, S, side, side, nan_frac=nan_frac,
                               blend=blend)
        imgs, _, p0, valid = inputs[:4]
        imgs[0] = np.nan                                  # an all-NaN stamp
        if S > 1:                                         # a star clipped at the stamp edge
            valid[1, 1] = True
            p0[1, 1], p0[1, S + 1], p0[1, 2 * S + 1] = -2.6, side / 2, 2000.0
        got, want = psf_pair(inputs, prfs[K], S, n_iters)
        pg = got["params"].cpu().numpy()
        check(np.array_equal(pg[0], p0[0]), "all-NaN stamp: parameters moved")
        check(n_iters > 0 or np.array_equal(pg, p0), "0 iterations: parameters moved")
        check(np.isfinite(pg[1:]).all(), "non-finite parameters")
        rv = pg[:, :S][valid]
        check(n_iters == 0 or bool(np.all((rv >= -2.0) & (rv <= side + 1.0))),
              "a valid row escaped its clip")
        psf_err = max(psf_err, psf_fit_check(got, want, valid, S, "crowded",
                                             f"adversarial S={S} K={K} {side}x{side} "
                                             f"it={n_iters} B={B}"))

    pm = PSF_MAIN
    B_main = pm["N"] * T
    inputs = psf_instances(rng_fit, prfs[pm["K"]], B_main, pm["S"], pm["h"], pm["h"],
                           n_cfg=pm["N"], nan_frac=0.001)
    ins = [torch.as_tensor(a, device=dev) for a in inputs]
    fit_args = (ins[0], ins[1], 1.0, *ins[2:], prfs[pm["K"]], (pm["h"], pm["h"]), pm["S"],
                pm["n_iters"])
    got = fused_warm_fit_cuda(*fit_args)
    torch.cuda.synchronize()
    want = fused_warm_fit_plain(*fit_args)
    psf_fit_check(got, want, inputs[3], pm["S"], "crowded", f"main shape B={B_main}")
    psf_ms = cuda_ms(lambda: fused_warm_fit_cuda(*fit_args))
    psf_plain_ms = cuda_ms(lambda: fused_warm_fit_plain(*fit_args), reps=3)
    ne_flops, rest_flops = psf_flops(B_main, pm["S"], pm["K"], pm["h"], pm["h"], pm["n_iters"])
    flops = ne_flops + rest_flops
    nbytes = psf_bytes(B_main, pm["S"], pm["h"], pm["h"])
    f32_bound = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    # The normal equations may run on the tensor cores in 3xTF32 (three TF32
    # products each), the rest on the float32 pipes:
    tc_bound = max(ne_flops / (PEAK_TF32 / 3) + rest_flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    print(f"phase 2b main shape {pm['N']} x {T} instances {pm['h']}x{pm['h']} S={pm['S']} "
          f"K={pm['K']} it={pm['n_iters']}: kernel {psf_ms:.3f} ms, plain {psf_plain_ms:.3f} ms "
          f"(median); bound {tc_bound:.3f} ms by operations with the normal equations in "
          f"3xTF32 ({ne_flops / 1e9:.1f} GFLOP at {PEAK_TF32 / 3e12:.0f} TFLOP/s + "
          f"{rest_flops / 1e9:.1f} GFLOP at {PEAK_F32 / 1e12:.0f}), {f32_bound:.3f} ms all in "
          f"float32 ({flops / 1e9:.1f} GFLOP); {nbytes / 1e9:.3f} GB ({card})", flush=True)
    result["psf_warm_fit"].update(max_abs_err=psf_err, ms=psf_ms, plain_ms=psf_plain_ms,
                                  bound_ms=tc_bound,
                                  bound_by="operations" if tc_bound > nbytes / PEAK_BYTES * 1e3
                                  else "bytes")
    del ins, got, want
    lap("2b")

    # --- phase 2c: median and histogram kernels vs plain ---------------------
    median_phase(dev, rng, gen, card, result)
    hist_phase(dev, rng, card, result, img0)
    lap("2c")

    # --- phase 2d: stamp kernel vs plain (its main shape runs after phase 3) -------
    stamp_adv_err = stamp_adversarial(dev, rng)
    lap("2d adversarial")

    # --- phase 3: the aperture slice ---------------------------------------
    wcs, ctx_kw, ctx = photometry_context(work, rows, cols, tmag,
                                          (images, errs, bkgs, flags), dev)
    check(ctx.images.data_ptr() == images.data_ptr(), "from_arrays copied the cube")
    starid = np.arange(1, N_STARS + 1)
    sids = [int(s) for s in starid[:N_TARGETS]]           # the brightest (tmag sorted)

    captured = []

    def recording_band_sums(*a, **kw):
        """bandext.band_sums as the main path calls it, its arguments kept."""
        captured.append((a, kw))
        return band_sums(*a, **kw)

    band_sums = bandext.band_sums
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base3 = torch.cuda.memory_allocated()
    reset_counts()
    tic = time.perf_counter()
    with mock.patch.object(bandext, "band_sums", recording_band_sums):
        results = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    walls = {"3": wall, "3 peak": torch.cuda.max_memory_allocated() - base3}
    result["band_extract"]["launches"] = BAND_EXTRACT.launches
    check(BAND_EXTRACT.launches > 0, "the aperture slice did not launch the band kernel")
    print(f"phase 3 slice: {N_TARGETS} targets in {wall:.2f} s = {N_TARGETS / wall:.1f} "
          f"targets/s ({card}); band kernel launches {BAND_EXTRACT.launches}; peak device "
          f"memory {walls['3 peak'] / 1e9:.2f} GB above the {base3 / 1e9:.1f} GB held",
          flush=True)
    band_main_phase(captured, card)
    captured.clear()                      # the launch's arguments hold phase 3's cubes

    good = [r for r in results if r.status in (STATUS.OK, STATUS.WARNING)]
    n_ok = sum(r.status == STATUS.OK for r in results)
    print(f"phase 3 statuses: {n_ok} OK, {len(good) - n_ok} WARNING, "
          f"{len(results) - len(good)} other", flush=True)
    check(len(good) >= 0.9 * N_TARGETS, "fewer than 90% of targets OK or WARNING")
    for r in good:
        check(r.lightcurve["flux"].shape == (T,), f"TIC {r.starid}: flux shape")
        check(np.isfinite(r.lightcurve["flux"]).mean() > 0.99, f"TIC {r.starid}: flux not finite")

    # 1,024 of them again through the plain path on the card:
    sub = good[:N_PLAIN]
    hh = max(r.mask.shape[0] for r in sub)
    ww = max(r.mask.shape[1] for r in sub)
    masks = np.zeros((len(sub), hh, ww), bool)
    windows = np.zeros_like(masks)
    r0s = np.array([min(r.stamp[0], H - hh) for r in sub], np.int32)
    c0s = np.array([min(r.stamp[2], W - ww) for r in sub], np.int32)
    for i, r in enumerate(sub):
        dr, dc = r.stamp[0] - r0s[i], r.stamp[2] - c0s[i]
        masks[i, dr:dr + r.mask.shape[0], dc:dc + r.mask.shape[1]] = r.mask
        windows[i, dr:dr + r.mask.shape[0], dc:dc + r.mask.shape[1]] = True
    plain = host(extract_flux_core(
        *(images, errs, bkgs, flags), *(torch.as_tensor(a, device=dev) for a in
                                        (masks, r0s, c0s)), hh, ww,
        windows=torch.as_tensor(windows, device=dev)))
    keys = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")
    got = [np.stack([r.lightcurve[k] for r in sub]) for k in keys]
    slice_err = max_err(got, plain, "slice vs plain")
    result["band_extract"]["max_abs_err"] = max(result["band_extract"]["max_abs_err"], slice_err)
    print(f"phase 3 plain re-extraction of {len(sub)} targets agrees "
          f"(max |diff| {slice_err:.3g})", flush=True)

    def lease(method, n, folder):
        """One n-task lease through the dispatcher, products written and read back."""
        tasks = [{"priority": i + 1, "starid": sid, "sector": 1, "camera": 1, "ccd": 1,
                  "cadence": 1800, "datasource": "ffi", "tmag": float(tmag[sid - 1]),
                  "method": method} for i, sid in enumerate(sids[:n])]
        tic = time.perf_counter()
        out = photometry_batch(ctx, tasks, output_folder=os.path.join(work, folder), version=1,
                               save=True)
        took = time.perf_counter() - tic
        saved = [r for r in out if r.details.get("filepath_lightcurve")]
        check(len(saved) >= 0.9 * n, f"fewer than 90% of the {method} lease wrote products")
        for r in saved[:3]:
            lc = pf.read_fits(r.details["filepath_lightcurve"])[1].data
            check(np.allclose(lc["FLUX_RAW"], r.lightcurve["flux"], rtol=1e-6, equal_nan=True),
                  f"TIC {r.starid}: FLUX_RAW in the {method} product differs")
        print(f"phase {3 if method == 'aperture' else 4} lease: {n} {method} tasks with "
              f"products in {took:.2f} s ({card}); {len(saved)} written, 3 read back and equal",
              flush=True)

    lease("aperture", N_LEASE, "products")
    lap("3")

    # --- phase 3b: the aperture slice and the models on bfloat16 cubes --------------
    bf16_slice(ctx_kw, sids, results, prfs[3], card, result)
    lap("3b")

    # --- phase 3c: phase 3's cube on the host, streamed through the card ----------
    host_slice(ctx_kw, ctx, sids, results, prfs[3], card)
    lap("3c")

    # --- phase 2d, main shape: the phase-3 cube and targets ------------------------
    stamp_main(dev, (images, errs, bkgs, flags), results, rows, cols, card, result,
               stamp_adv_err)
    lap("2d main")

    # --- phase 4: the PSF slice ----------------------------------------------
    prf = prfs[3]
    ctx._context_prf = prf                     # as psf_common.context_prf memoizes it
    psf_sids = sids[:N_PSF]
    cat_all = _full_catalog_positions(ctx)
    groups = bucket_psf_groups(ctx, [setup_psf_target(ctx, s, cat_all) for s in psf_sids])
    n_fused_groups = sum(fused_ok(prf, hw_, 5, "Gaussian_d") for hw_ in groups)
    check(n_fused_groups > 0, f"no stamp bucket of the PSF slice takes the kernel: {list(groups)}")
    torch.cuda.synchronize()
    reset_counts()
    psf_fit.ROUTES.update(fused=0, plain=0)
    psf_calls = []                        # phase 11c's inputs: each fit call and its result
    run_fit = psf_fit.fit_psf_timeseries_batch

    def recording_fit(*a, **kw):
        out = run_fit(*a, **kw)
        psf_calls.append((a, out))
        return out

    tic = time.perf_counter()
    with mock.patch.object(psf_fit, "fit_psf_timeseries_batch", recording_fit):
        res_psf = psf_fit.extract_psf_batch(ctx, psf_sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    walls["4"] = wall
    routes = dict(psf_fit.ROUTES)
    result["psf_warm_fit"]["launches"] = PSF_WARM_FIT.launches
    print(f"phase 4 slice: {N_PSF} PSF targets in {wall:.2f} s = {N_PSF / wall:.1f} targets/s "
          f"({card}); buckets {sorted(groups)}; PSF kernel launches {PSF_WARM_FIT.launches}; "
          f"target groups fused {routes['fused']}, plain {routes['plain']}", flush=True)
    check(PSF_WARM_FIT.launches > 0, "the PSF slice did not launch the PSF kernel")
    check(routes["plain"] == len(groups) - n_fused_groups,
          f"a group the kernel takes went to the plain fitter: {routes}")
    good = [r for r in res_psf if r.status in (STATUS.OK, STATUS.WARNING)
            and np.isfinite(r.lightcurve["flux"]).mean() > 0.99
            and np.isfinite(r.lightcurve["flux_err"]).mean() > 0.99]
    print(f"phase 4 statuses: {len(good)} of {N_PSF} OK or WARNING with finite flux and "
          f"flux_err", flush=True)
    check(len(good) >= 0.9 * N_PSF, "fewer than 90% of PSF targets OK/WARNING and finite")

    n_spans = psf_profile(ctx, psf_sids, wall, card, "phase 4 profile")
    check(n_spans == result["psf_warm_fit"]["launches"],
          f"profiled {n_spans} psf_warm_fit launches, the timed slice counted "
          f"{result['psf_warm_fit']['launches']}")

    # 128 of them again through the plain fitter on the card:
    refit = psf_fit.extract_psf_batch(ctx, psf_sids[:N_PSF_PLAIN], fused=False)
    fracs = {}
    for k, rtol, atol in (("flux", 2e-2, 0.0), ("flux_err", 5e-2, 0.0),
                          ("pos_centroid", 0.0, 2e-2)):
        a = np.stack([r.lightcurve[k] for r in res_psf[:N_PSF_PLAIN]])
        b = np.stack([r.lightcurve[k] for r in refit])
        ok = (np.abs(a - b) <= atol + rtol * np.abs(b)) | (np.isnan(a) & np.isnan(b))
        fracs[k] = float(ok.mean())
    print(f"phase 4 plain re-fit of {N_PSF_PLAIN} targets x {T} cadences: share within the "
          f"bounds of test_batch_fused_path_matches_xla {fracs}", flush=True)
    check(min(fracs.values()) >= 0.99, "kernel and plain fitter disagree on more than 1%")

    lease("psf", N_LEASE, "products_psf")
    ctx.close()
    lap("4")

    # --- phase 11: phase 3's cubes on a mesh of four entries of the card -------------
    mesh_phase(ctx_kw, sids, results, psf_calls, walls, card)
    del psf_calls
    nccl_phase(card)
    lap("11")

    # --- phase 6: ECC registration against injected motion --------------------------
    ecc_phase(dev, img0, gen, rng, ctx_kw, sids, card)
    lap("6")

    # --- phase 8: Target Pixel Files through the drain, beside phase 3's context -----
    p8_folder = tpf_phase(work, dev, gens["8"], np.random.default_rng([args.seed, 9]), ctx_kw,
                          rows, cols, tmag, wcs, card)
    lap("8")

    # --- phase 7: the default-method drain, on phase 3's cubes ----------------------
    p7 = drain_phase(work, dev, gen, np.random.default_rng([args.seed, 7]),
                     (images, errs, bkgs, flags), img0, rows, cols, tmag, wcs, card)
    lap("7")

    # --- phase 11e: phase 7's tasks drained with and without a mesh ------------------
    mesh_drain(p7, dev, card)
    del p7
    lap("11e")
    del ctx, ctx_kw, cube, launch, images, errs, bkgs, flags, res_psf, refit, results
    torch.cuda.empty_cache()

    # --- phase 3b, full sector: T = 1,312 in bfloat16, phase 3's cubes freed ---------
    catalog16, sector16 = bf16_sector(work, dev, gens["3b sector"], img0, rows, cols, tmag,
                                      wcs, sids, card)
    lap("3b sector")

    # --- phase 3c, full sector: T = 1,312 in float32 on the host, streamed -----------
    # (made from the generator state phase 3b's sector was made from)
    host_sector(work, dev, seeds["3b sector"], img0, catalog16, wcs, sids, sector16, card)
    del sector16
    lap("3c sector")

    # --- phase 5: the prepare slice --------------------------------------------
    store, tpf = prepare_phase(work, img0, rows, cols, tmag, wcs, dev, gen, card, result)
    lap("5")

    # --- phase 9: catalog -> todo -> drain -> merge on phase 5's store -----------
    chain_phase(work, dev, store, tpf, rows, cols, tmag, wcs, card)
    del store
    lap("9")

    # --- phase 10: several workers drain one todo list; diagnostics ---------------
    scheduler_phase(work, p8_folder, args.seed, dev, card)
    lap("10")
    print(f"phases 1-11 took {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{name} {b - a:.1f} s" for (_, a), (name, b) in zip(laps, laps[1:])),
          flush=True)

    print(json.dumps({"kernels": [result[name] for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
