"""
Sharded whole-cube programs: the multi-card prepare and extraction steps.

Port of ``photometry_tpu/parallel/sharded.py``.  A sector cube lives
time-sharded over a :class:`~.mesh.Mesh` (:class:`~.mesh.ShardedCube`: one
block of frames a mesh row); targets shard over the other axis, or over
the flattened mesh for the per-target fits.  What JAX's ``shard_map`` and
collectives did, these functions do shard by shard:

- the per-frame and per-target programs run once per shard on the shard's
  device, with no communication.  The extraction's blocks call the same
  ``ops.bandext.band_extract_flux_batch`` as the single-device path (the
  CUDA kernel ``band_extract.cu`` on a card, its plain version on the CPU);
  every output element depends on one (target, cadence) pair, so the
  blocks concatenate to the single-device result bit for bit.  The PSF
  fits of a shard go through ``models.psf_fit.fit_psf_timeseries_batch``
  (``psf_warm_fit.cu`` on a card);
- :func:`sharded_time_smooth` copies ``window // 2`` halo frames between
  neighbouring shards (a copy between cards, nothing on one device; send
  and receive between processes);
- :func:`sharded_sumimage` adds the shards' partial sums and counts in
  mesh order on one device (gathered with ``all_gather`` between
  processes), so the result does not depend on how the cube is split.

On a mesh that spans processes (``multihost.global_mesh``), each process
holds and computes the shards of its own mesh entries; only the two
programs above exchange data.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import TARGET_AXIS, TIME_AXIS, Mesh, ShardedCube, shard_cube

__all__ = ["sharded_psf_fit", "sharded_linpsf_fit", "sharded_halo_weights",
           "sharded_time_smooth", "sharded_sumimage", "sharded_extract_flux",
           "sharded_band_extract", "prepare_step", "extraction_step", "pad_to_multiple"]


def pad_to_multiple(arr, axis: int, multiple: int, fill=np.nan):
    """Pad ``arr`` along ``axis`` up to the next multiple (host-side).

    Returns (padded, original_size).  Sharded programs need every sharded
    axis divisible by its mesh-axis size; callers slice the outputs back.
    """
    arr = np.asarray(arr)
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_shape = list(arr.shape)
    pad_shape[axis] = rem
    pad = np.full(pad_shape, fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=axis), n


def _as_cube(x, mesh: Mesh, fill=float("nan")) -> ShardedCube:
    """A ShardedCube of ``x``: as it is, or an array whose T the time axis
    must divide (as the JAX programs' shard_map requires)."""
    if isinstance(x, ShardedCube):
        return x
    if x.shape[0] % mesh.shape[TIME_AXIS]:
        raise ValueError(f"T={x.shape[0]} must divide the time-axis size "
                         f"{mesh.shape[TIME_AXIS]} (pad with pad_to_multiple)")
    return shard_cube(x, mesh, fill=fill)


def _grouped(mesh: Mesh) -> bool:
    """True when the mesh's entries are a process group's (global_mesh):
    its shards then exchange through torch.distributed."""
    from . import multihost
    return multihost.is_initialized() and any(
        hasattr(d, "process_index") for d in mesh.devices.flat)


def _owner(mesh: Mesh, i: int) -> int:
    return int(getattr(mesh.devices[i, 0], "process_index", 0))


# ---------------------------------------------------------------------------
# Time-axis programs with communication
# ---------------------------------------------------------------------------

def _halos(cube: ShardedCube, half: int):
    """(previous row's last ``half`` frames, next row's first ``half``) for
    each row held, on its device; NaN past either end of the cube.  Rows
    of another process send and receive theirs (tag 2r: row r's tail to
    row r+1; tag 2r+1: row r's head to row r-1)."""
    shards, mesh = cube.shards, cube.mesh
    n = len(shards)
    prev, nxt, ops = {}, {}, []
    if half == 0:
        return prev, nxt
    if cube.frames < half:
        raise ValueError(f"{cube.frames} frames a shard is fewer than the halo's {half}")
    for i in cube.rows():
        x = shards[i]
        shape = (half,) + tuple(x.shape[1:])
        for k, want, mine, tag_in, tag_out, out in (
                (i - 1, lambda s: s[-half:], x[:half], 2 * (i - 1), 2 * i + 1, prev),
                (i + 1, lambda s: s[:half], x[-half:], 2 * (i + 1) + 1, 2 * i, nxt)):
            if not 0 <= k < n:
                out[i] = torch.full(shape, torch.nan, dtype=x.dtype, device=x.device)
            elif shards[k] is not None:
                out[i] = want(shards[k]).to(x.device)
            else:
                import torch.distributed as dist
                out[i] = torch.empty(shape, dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, out[i], _owner(mesh, k), tag=tag_in))
                ops.append(dist.P2POp(dist.isend, mine.contiguous(), _owner(mesh, k),
                                      tag=tag_out))
    if ops:
        import torch.distributed as dist
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return prev, nxt


def sharded_time_smooth(bkg, mesh: Mesh, window: int = 3) -> ShardedCube:
    """Moving-mean smoothing along the sharded time axis with a halo
    exchange (the multi-card form of reference prepare.py:309-338).

    Each shard takes its neighbours' ``window // 2`` boundary frames (NaN
    beyond the cube's two ends) and smooths locally with the JAX program's
    nanmean weighting: the sum of the finite frames in the window over
    their count, 0 where none is finite.  Returns a ShardedCube.
    """
    cube = _as_cube(bkg, mesh)
    half = window // 2
    prev, nxt = _halos(cube, half)
    out = []
    for i, x in enumerate(cube.shards):
        if x is None:
            out.append(None)
            continue
        ext = torch.cat([prev[i], x, nxt[i]]) if half else x
        stack = torch.stack([ext[k:k + x.shape[0]] for k in range(window)])
        fin = torch.isfinite(stack)
        cnt = fin.sum(dim=0)
        out.append(torch.where(fin, stack, 0.0).sum(dim=0) / torch.clamp(cnt, min=1))
    return ShardedCube(out, mesh, cube.n_times)


def _row_flags(flags, cube: ShardedCube, fill=False) -> list:
    """A per-frame (T,) array -> its part of each row held, on the row's
    device (padded to the cube's padded T with ``fill``)."""
    f = torch.as_tensor(np.asarray(flags) if not isinstance(flags, torch.Tensor) else flags)
    T = cube.shape[0]
    if f.shape[0] < T:
        f = torch.cat([f.cpu(), torch.full((T - f.shape[0],), fill, dtype=f.dtype)])
    F = cube.frames
    return [None if s is None else f[i * F:(i + 1) * F].to(s.device)
            for i, s in enumerate(cube.shards)]


def sharded_sumimage(images, quality_good, mesh: Mesh) -> torch.Tensor:
    """Mean of the quality-good finite frames of a time-sharded cube.

    Each shard's partial sum (float32) and count are added in mesh order on
    the first held shard's device; between processes the partials go by
    ``all_gather`` first.  So the bits do not depend on how the cube is
    split over processes.  Returns the (H, W) mean (0 where no frame is
    good and finite, as the JAX program's ``s / max(n, 1)``).
    """
    cube = _as_cube(images, mesh)
    good = _row_flags(quality_good, cube)
    dev = cube.device
    sums, counts = {}, {}
    for i in cube.rows():
        x = cube.shards[i]
        fin = torch.isfinite(x) & good[i].to(torch.bool)[:, None, None]
        sums[i] = torch.where(fin, x.to(torch.float32), 0.0).sum(dim=0).to(dev)
        counts[i] = fin.sum(dim=0).to(dev)
    n = len(cube.shards)
    if _grouped(mesh):
        import torch.distributed as dist
        hw = tuple(cube.shape[1:])
        mine_s = torch.zeros((n,) + hw, dtype=torch.float32, device=dev)
        mine_n = torch.zeros((n,) + hw, dtype=torch.int64, device=dev)
        for i in sums:
            mine_s[i], mine_n[i] = sums[i], counts[i]
        size = dist.get_world_size()
        all_s = [torch.empty_like(mine_s) for _ in range(size)]
        all_n = [torch.empty_like(mine_n) for _ in range(size)]
        dist.all_gather(all_s, mine_s)
        dist.all_gather(all_n, mine_n)
        sums = {i: all_s[_owner(mesh, i)][i] for i in range(n)}
        counts = {i: all_n[_owner(mesh, i)][i] for i in range(n)}
    elif len(sums) != n:
        raise ValueError("the cube's rows are spread over processes, but no process group is up")
    total, count = sums[0], counts[0]
    for i in range(1, n):
        total = total + sums[i]
        count = count + counts[i]
    return total / torch.clamp(count, min=1)


# ---------------------------------------------------------------------------
# Extraction over (time shard, target shard) blocks
# ---------------------------------------------------------------------------

def _targets(masks, r0s, c0s, windows):
    """The target arrays as tensors: masks/windows bool, corners int32."""
    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(dtype)
    return t(masks, torch.bool), t(r0s, torch.int32), t(c0s, torch.int32), t(windows, torch.bool)


def _run_blocks(cubes, targets, mesh: Mesh, h: int, w: int, n_split: int, out_device):
    """band_extract_flux_batch on each (time row held, target part) block,
    the parts on mesh entry (i, j) (entry (i, 0) for every part when the
    targets are not sharded), outputs concatenated on ``out_device``:
    targets along dim 0, time along dim 1."""
    from ..ops.bandext import band_extract_flux_batch
    masks, r0s, c0s, windows = targets
    N = masks.shape[0]
    if N % n_split:
        raise ValueError(f"N={N} targets must divide the target-axis size {n_split} "
                         f"(pad with pad_to_multiple)")
    per = N // n_split
    rows, dev_out = [], out_device
    for i in cubes[0].rows():
        parts = []
        for j in range(n_split):
            col = j if n_split == mesh.shape[TARGET_AXIS] else 0
            dev = mesh.device(i, col)
            sl = slice(j * per, (j + 1) * per)
            planes = [c.block(i, col) for c in cubes]
            parts.append(band_extract_flux_batch(
                *planes, masks[sl].to(dev), r0s[sl].to(dev), c0s[sl].to(dev), h, w,
                windows=None if windows is None else windows[sl].to(dev)))
        dev_out = dev_out or parts[0][0].device
        rows.append([torch.cat([p[k].to(dev_out) for p in parts]) for k in range(5)])
    return tuple(torch.cat([r[k].to(dev_out) for r in rows], dim=1) for k in range(5))


def sharded_extract_flux(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                         mesh: Mesh, h: int, w: int, windows=None, out_device=None):
    """Aperture extraction over a (time x targets) mesh.

    The cubes are ShardedCubes (a mesh context's) or arrays whose T the
    time axis divides (sharded here, as the JAX program puts them); N must
    divide by the target-axis size.  Block (i, j) (row i's frames, target
    part j) runs ``band_extract_flux_batch`` on mesh entry (i, j)'s device:
    the band kernel on a card, its plain version on the CPU.  ``windows``
    (N, h, w) limits the shenanigans flag to each target's logical stamp.
    Returns flux, flux_err, flux_bkg (N, T), centroid (N, T, 2) and
    shenanigans_any (N, T) at the padded T, on ``out_device`` (the first
    block's device if None); on a mesh spanning processes, T covers this
    process's rows.
    """
    cubes = [_as_cube(x, mesh, fill) for x, fill in
             ((images, float("nan")), (images_err, float("nan")),
              (backgrounds, float("nan")), (pixelflags, 0))]
    return _run_blocks(cubes, _targets(masks, r0s, c0s, windows), mesh, h, w,
                       mesh.shape[TARGET_AXIS], out_device)


def sharded_band_extract(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                         mesh: Mesh, h: int, w: int, windows=None, out_device=None):
    """Time-sharded banded extraction: one ``band_extract_flux_batch`` of
    every target per time shard (the band kernel once per shard on a card),
    on the row's first device.  Outputs as :func:`sharded_extract_flux`'s.
    """
    cubes = [_as_cube(x, mesh, fill) for x, fill in
             ((images, float("nan")), (images_err, float("nan")),
              (backgrounds, float("nan")), (pixelflags, 0))]
    return _run_blocks(cubes, _targets(masks, r0s, c0s, windows), mesh, h, w, 1, out_device)


def prepare_step(images, quality, mesh: Mesh, tile: int = 16, window: int = 3):
    """One multi-card prepare step: per-frame backgrounds, their time
    smoothing, the subtraction and the sum image.

    ``images`` (T, H, W) is a ShardedCube or an array (sharded here, T
    padded with NaN frames); the background of each shard is
    ``ops.background.estimate_background(shard, tile=tile)`` (no camera, so
    no radial rings).  Returns (images_subtracted, backgrounds_smoothed) as
    ShardedCubes and the (H, W) sum image.
    """
    from ..ops.background import estimate_background
    cube = shard_cube(images, mesh).map(lambda s: s.to(torch.float32))
    bkg = cube.map(lambda s: estimate_background(s, tile=tile)[0])
    bkg_s = sharded_time_smooth(bkg, mesh, window=window)
    sub = ShardedCube([None if a is None else a - b for a, b in zip(cube.shards, bkg_s.shards)],
                      mesh, cube.n_times)
    good = np.asarray(quality) == 0
    return sub, bkg_s, sharded_sumimage(sub, good, mesh)


def extraction_step(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, time,
                    quality, mesh: Mesh, h: int, w: int):
    """One multi-card extraction step: the light-curve columns of the
    single-device engine (flux, flux_err, flux_bkg, pos_centroid,
    shenanigans_any; BasePhotometry.py:1323-1414) cut to ``len(time)``
    cadences, and their metrics (``core.metrics.compute_metrics_batch``).
    """
    from ..core.metrics import compute_metrics_batch
    flux, ferr, fbkg, cent, shen = sharded_extract_flux(
        images, images_err, backgrounds, pixelflags, masks, r0s, c0s, mesh, h, w)
    T = len(time)
    flux, ferr, fbkg, cent, shen = (x[:, :T].contiguous() for x in (flux, ferr, fbkg, cent, shen))
    dev = flux.device
    metrics = compute_metrics_batch(torch.as_tensor(np.asarray(time), dtype=torch.float32,
                                                    device=dev),
                                    flux, ferr, torch.as_tensor(np.asarray(quality), device=dev),
                                    cent)
    lightcurves = {"flux": flux, "flux_err": ferr, "flux_bkg": fbkg, "pos_centroid": cent,
                   "shenanigans_any": shen}
    return lightcurves, metrics


# ---------------------------------------------------------------------------
# Per-target programs over the flattened mesh
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _flat_parts(mesh: Mesh, N: int):
    """(flat index, entry's device, index of its targets) for every entry
    of this process: N padded to the mesh size by repeating the last
    target, as the JAX programs pad; a slice where no padding is in it."""
    per = -(-N // mesh.size)
    out = []
    for k, i, j in mesh.flat():
        if not mesh.is_local(i, j):
            continue
        lo, hi = k * per, (k + 1) * per
        idx = slice(lo, hi) if hi <= N else torch.clamp(torch.arange(lo, hi), max=N - 1)
        out.append((k, mesh.device(i, j), idx, max(0, min(per, N - lo))))
    return out


def _on(a: torch.Tensor, idx, dev) -> torch.Tensor:
    part = a[idx] if isinstance(idx, slice) else a[idx.to(a.device)]
    return part.to(dev)


def _flat_map(mesh: Mesh, arrays, fn):
    """``fn(device, *parts)`` -> dict or tuple of (n, ...) tensors, on every
    entry's part of ``arrays`` (the target axis first); the parts' outputs
    concatenated on the first part's device, the padding rows dropped."""
    arrays = [_as_tensor(a) for a in arrays]
    N = arrays[0].shape[0]
    outs = []
    for _, dev, idx, n_real in _flat_parts(mesh, N):
        res = fn(dev, *(_on(a, idx, dev) for a in arrays))
        outs.append((res, n_real))
    first = outs[0][0]
    dev_out = next(iter(first.values())).device if isinstance(first, dict) else first[0].device

    def cat(get):
        return torch.cat([get(r)[:n].to(dev_out) for r, n in outs])
    if isinstance(first, dict):
        return {k: cat(lambda r, k=k: r[k]) for k in first}
    return tuple(cat(lambda r, k=k: r[k]) for k in range(len(first)))


def _same_device(a: torch.device, b: torch.device) -> bool:
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def _prf_on(prf, dev: torch.device):
    """The PRF with its tables on ``dev`` (a copy per device, kept on it)."""
    if _same_device(prf.device, dev):
        return prf
    copies = prf.__dict__.setdefault("_mesh_copies", {})
    if str(dev) not in copies:
        from ..models.prf import PRF
        copies[str(dev)] = PRF(prf.iprf, prf.oversample, prf.center_x, prf.center_y,
                               info=prf.info, device=dev)
    return copies[str(dev)]


def sharded_psf_fit(images, backgrounds, var_const, p0, valid, mini_ap, target_idx, prf,
                    shape, S: int, mesh: Mesh, lhood_stat: str = "Gaussian_d") -> dict:
    """Target-sharded PSF LM fits over every entry of the mesh.

    The fit is independent per target, so N is split over the FLATTENED
    (time x targets) mesh with no communication, padded to the mesh size by
    repeating the last target (dropped from the result).  Each part runs
    ``models.psf_fit.fit_psf_timeseries_batch`` on its entry's device
    (``psf_warm_fit.cu`` on a card where ``fused_ok`` admits the
    configuration).  Returns its dict, rows in target order.
    """
    from ..models.psf_fit import fit_psf_timeseries_batch

    def fit(dev, im, bk, p, v, m, t):
        return fit_psf_timeseries_batch(im, bk, var_const, p, v, m, t, _prf_on(prf, dev),
                                        shape, S, lhood_stat)
    return _flat_map(mesh, (images, backgrounds, p0, valid, mini_ap, target_idx), fit)


def sharded_linpsf_fit(images, rows_t, cols_t, valid, prf, shape, S: int, mesh: Mesh) -> dict:
    """Target-sharded linear-PSF solves (``models.linpsf.linpsf_timeseries_batch``)
    over the flattened mesh, as :func:`sharded_psf_fit`."""
    from ..models.linpsf import linpsf_timeseries_batch

    def solve(dev, im, r, c, v):
        return linpsf_timeseries_batch(im, r, c, v, _prf_on(prf, dev), shape, S)
    return _flat_map(mesh, (images, rows_t, cols_t, valid), solve)


def sharded_halo_weights(flux_norm, good_time, mesh: Mesh, objective: str = "tv"):
    """Target-sharded TV-min weights (halo photometry) over the flattened mesh.

    ``flux_norm`` (N, T, P) median-normalised pixel fluxes, ``good_time``
    (T,) shared.  Each part runs ``models.halo.tvmin_weights_batch`` with
    every pixel valid.  Returns (N, P) weights and (N,) objective values.
    """
    from ..models.halo import tvmin_weights_batch
    good = _as_tensor(good_time).to(torch.bool)

    def weights(dev, f):
        f = f.to(torch.float32)
        n, _, P = f.shape
        return tvmin_weights_batch(f, good.to(dev)[None].expand(n, -1),
                                   torch.ones((n, P), dtype=torch.bool, device=dev),
                                   objective=objective)
    return _flat_map(mesh, (flux_norm,), weights)
