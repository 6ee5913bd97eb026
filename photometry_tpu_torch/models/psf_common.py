"""
Shared machinery of the PSF photometry models, on torch tensors.

Port of ``photometry_tpu/models/psf_common.py``.  Target setup replicates
reference psf_photometry.py:117-129: fit the <=5 nearest catalog stars
within 5 px of the main target that are not more than 5 mag fainter; star
positions per cadence come from the jitter-shifted catalog.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.engine import default_stamp_size
from ..io.settings import data_dir
from ..parallel.mesh import ShardedCube, map_time
from ..utils.mathutils import mag2flux
from .prf import PRF

__all__ = ["MAX_FIT_STARS", "CUTOFF_RADIUS", "DUMMY_POS", "PSF_BUCKET_LADDER",
           "PsfTargetSetup", "context_prf", "setup_psf_target", "bucket_psf_groups",
           "gather_stamp_stack", "logical_stamp_mask", "minimum_aperture_mask"]

MAX_FIT_STARS = 5
FIT_RADIUS = 5.0
DMAG_LIMIT = -5.0
CUTOFF_RADIUS = 5.0

#: Dummy star placed far outside the stamp (zero PRF contribution).
DUMMY_POS = -1000.0


def context_prf(ctx, prf: Optional[PRF] = None) -> PRF:
    """The PRF of a context: the calibrated table when ``data/psf`` holds
    one, else an integrated Gaussian (sigma from the PSFSIGMA header).

    Memoized on the context as ``ctx._context_prf``, so every consumer of
    one context sees the same object; setting that attribute gives a
    context a PRF of the caller's choosing.
    """
    if prf is not None:
        return prf
    cached = getattr(ctx, "_context_prf", None)
    if cached is not None:
        return cached
    built = None
    psf_dir = os.path.join(data_dir(), "psf")
    if os.path.isdir(psf_dir):
        try:
            h, w = ctx.shape
            built = PRF.from_mat(psf_dir, max(ctx.sector, 1), ctx.camera, ctx.ccd,
                                 (0, h, 0, w), device=ctx.device)
        except FileNotFoundError:
            pass
    if built is None:
        sigma = float(ctx.header.get("PSFSIGMA", 1.25)) if hasattr(ctx, "header") else 1.25
        built = PRF.gaussian(sigma=sigma, device=ctx.device)
    ctx._context_prf = built
    return built


@dataclass
class PsfTargetSetup:
    starid: int
    target: dict
    stamp: tuple                 #: (r0, r1, c0, c1) clipped
    rows0: np.ndarray            #: (S,) star rows in stamp coords at ref time
    cols0: np.ndarray            #: (S,)
    fluxes0: np.ndarray          #: (S,) initial fluxes from tmag
    star_ids: np.ndarray         #: (S,)
    star_tmags: np.ndarray       #: (S,)
    valid: np.ndarray            #: (S,) real star vs dummy padding
    target_idx: int              #: index of the main target within the S slots
    target_row: float            #: main target in stamp coords
    target_col: float


def setup_psf_target(ctx, starid: int, cat_all) -> PsfTargetSetup:
    """Select and package the stars to fit around one target;
    ``cat_all`` is ``core.engine._full_catalog_positions(ctx)``."""
    tgt = ctx.catalog.target(starid)
    row, col = ctx.target_position(tgt["ra"], tgt["decl"])
    H, W = ctx.shape
    if ctx.datasource.startswith("tpf"):
        stamp = (0, H, 0, W)          # the whole postage stamp
    else:
        nr, nc = default_stamp_size(tgt["tmag"])
        stamp = (max(int(round(row)) - nr // 2, 0),
                 min(int(round(row)) + nr // 2 + 1, H),
                 max(int(round(col)) - nc // 2, 0),
                 min(int(round(col)) + nc // 2 + 1, W))

    dist = np.hypot(cat_all["row"] - row, cat_all["col"] - col)
    sel = (dist < FIT_RADIUS) & ((tgt["tmag"] - cat_all["tmag"]) > DMAG_LIMIT)
    idx = np.where(sel)[0]
    idx = idx[np.argsort(dist[idx])][:MAX_FIT_STARS]
    # The main target must be among the fitted stars:
    tpos = np.where(cat_all["starid"][idx] == starid)[0]
    if len(tpos) == 0:
        idx = np.concatenate([[int(np.argmax(cat_all["starid"] == starid))], idx])[:MAX_FIT_STARS]
        tpos = np.array([0])
    target_idx = int(tpos[0])

    S = MAX_FIT_STARS
    rows0 = np.full(S, DUMMY_POS)
    cols0 = np.full(S, DUMMY_POS)
    fluxes0 = np.zeros(S)
    star_ids = np.zeros(S, np.int64)
    star_tmags = np.full(S, 30.0)
    valid = np.zeros(S, bool)
    k = len(idx)
    rows0[:k] = cat_all["row"][idx] - stamp[0]
    cols0[:k] = cat_all["col"][idx] - stamp[2]
    fluxes0[:k] = mag2flux(cat_all["tmag"][idx])
    star_ids[:k] = cat_all["starid"][idx]
    star_tmags[:k] = cat_all["tmag"][idx]
    valid[:k] = True
    return PsfTargetSetup(
        starid=starid, target=tgt, stamp=stamp, rows0=rows0, cols0=cols0,
        fluxes0=fluxes0, star_ids=star_ids, star_tmags=star_tmags, valid=valid,
        target_idx=target_idx, target_row=row - stamp[0], target_col=col - stamp[2])


#: Quantized stamp buckets: PSF batches share a handful of shapes.
PSF_BUCKET_LADDER = (15, 17, 25, 33, 49, 65, 97, 129, 161, 225, 337, 513,
                     769, 1025)


def bucket_psf_groups(ctx, setups) -> dict:
    """Group target setups by padded stamp bucket.

    Returns {(bh, bw): [(setup, r0, c0), ...]} where (r0, c0) anchors a
    bucket-sized window fully inside the CCD containing the logical stamp.
    """
    H, W = ctx.shape
    groups: dict = {}
    for st in setups:
        s = st.stamp
        nh, nw = s[1] - s[0], s[3] - s[2]
        bh = min(next((b for b in PSF_BUCKET_LADDER if b >= nh), nh), H)
        bw = min(next((b for b in PSF_BUCKET_LADDER if b >= nw), nw), W)
        r0 = max(min(s[0], H - bh), 0)
        c0 = max(min(s[2], W - bw), 0)
        groups.setdefault((bh, bw), []).append((st, r0, c0))
    return groups


def gather_stamp_stack(cube: torch.Tensor, r0s, c0s, bh: int, bw: int,
                       device=None) -> torch.Tensor:
    """(T, H, W) cube -> (N, T, bh, bw) float32 stamps on ``device`` (the
    cube's if None) by advanced indexing where the cube lies: gathered at
    the cube's dtype and widened after, so a bfloat16 cube is read at two
    bytes a pixel (as the JAX package's gather), and a host cube
    (``cache="host"``) is gathered on the host and only its stamps move
    (photometry_tpu/models/psf_common.py:173-175).  A time-sharded cube (a
    mesh context's ``ShardedCube``) is gathered shard by shard on each
    shard's device; the stamps move to ``device`` and are joined in time
    order, cut to the true T."""
    if isinstance(cube, ShardedCube):
        return map_time(cube, lambda s: gather_stamp_stack(s, r0s, c0s, bh, bw), 1, device)
    dev = cube.device
    rows = torch.as_tensor(np.asarray(r0s, np.int64), device=dev)[:, None] + torch.arange(bh, device=dev)
    cols = torch.as_tensor(np.asarray(c0s, np.int64), device=dev)[:, None] + torch.arange(bw, device=dev)
    out = cube[:, rows[:, :, None], cols[:, None, :]]                  # (T, N, bh, bw)
    return out.transpose(0, 1).to(dev if device is None else device, torch.float32)


def logical_stamp_mask(stamp, r0: int, c0: int, bh: int, bw: int) -> np.ndarray:
    """(bh, bw) bool mask of the bucket pixels inside the logical stamp."""
    yy, xx = np.mgrid[0:bh, 0:bw]
    return ((yy + r0 >= stamp[0]) & (yy + r0 < stamp[1])
            & (xx + c0 >= stamp[2]) & (xx + c0 < stamp[3]))


def minimum_aperture_mask(shape, target_row: float, target_col: float) -> np.ndarray:
    """2x2-ish pixel mask around the target (photometry.py:31-41)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    return (np.abs(xx - target_col) <= 1) & (np.abs(yy - target_row) <= 1)
