"""Stage-level profile of the K2P2 batched mask construction on a torch device.

The port's copy of ``tools/profile_k2p2.py``: times
``models.k2p2.build_masks_batch`` whole, then each of its stages alone, on
a production-shaped batch (2,048 stamps of 17x17, the bench chunk, drawn
with numpy seed 3 as the JAX tool draws them), so that kernel work lands
on the stage that costs.  The JAX tool's ``catalog markers`` stage is
``_catalog_markers``; the port writes it as ``_catalog_marker_pix`` and
``_rasterize_markers``, timed here together under that name.

Each stage runs once to warm up, then ``reps`` times, each between
``torch.cuda.synchronize()`` calls on a card; prints the median of each
stage in milliseconds, one line each as the JAX tool does.

Usage: python -m photometry_tpu_torch.tools.profile_k2p2 [-n 2048] [--hw 17]
       [--reps 5] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from ..core.engine import DEFAULT_K2P2_PARAMS as P
from ..device import resolve_device
from ..models import k2p2
from ..ops.filters import gaussian_blur2d
from ..ops.labeling import dbscan_labels, watershed_segment

K = 8          #: catalog slots of each stamp


def make_inputs(n: int, hw: int) -> dict:
    """The tool's seeded batch (numpy): n (hw, hw) stamps of 1-3 Gaussian
    stars on noise, their padded catalogs and targets (the first star)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    imgs = rng.normal(0, 1.5, (n, hw, hw)).astype(np.float32)
    cat_col = np.full((n, K), 1e9, np.float32)
    cat_row = np.full((n, K), 1e9, np.float32)
    cat_tmag = np.full((n, K), 30.0, np.float32)
    cat_valid = np.zeros((n, K), bool)
    for i in range(n):
        for j in range(int(rng.integers(1, 4))):
            r = rng.uniform(4, hw - 5)
            c = rng.uniform(4, hw - 5)
            a = rng.uniform(100, 4000)
            imgs[i] += (a * np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / 1.3 ** 2)
                        ).astype(np.float32)
            cat_row[i, j], cat_col[i, j], cat_tmag[i, j], cat_valid[i, j] = r, c, 12.0, True
    return {"imgs": imgs, "cat_col": cat_col, "cat_row": cat_row, "cat_tmag": cat_tmag,
            "cat_sid": np.arange(1, K + 1, dtype=np.int64)[None].repeat(n, 0),
            "cat_valid": cat_valid, "t_row": cat_row[:, 0].copy(),
            "t_col": cat_col[:, 0].copy(), "t_tmag": cat_tmag[:, 0].copy(),
            "coll": np.ones((n, hw, hw), bool)}


def batch_args(inputs: dict, device) -> tuple:
    """``build_masks_batch``'s positional arguments on ``device``."""
    return tuple(torch.as_tensor(inputs[k], device=device) for k in (
        "imgs", "cat_col", "cat_row", "cat_tmag", "cat_sid", "cat_valid", "t_row", "t_col",
        "t_tmag", "coll"))


def main(argv=None) -> dict:
    """Time the stages; returns ``{stage: median ms}``."""
    ap = argparse.ArgumentParser(description="Time the stages of the K2P2 mask construction.")
    ap.add_argument("-n", type=int, default=2048, help="stamps per batch")
    ap.add_argument("--hw", type=int, default=17, help="stamp side")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="Torch device (default: cuda).")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    hw = args.hw
    a = batch_args(make_inputs(args.n, hw), dev)
    imgs, cc, cr, ct, _, cv, _, _, _, coll = a
    times = {}

    def timed(name, fn, *xs):
        out = fn(*xs)                       # warm-up
        ts = []
        for _ in range(args.reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tic = time.perf_counter()
            out = fn(*xs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - tic)
        times[name] = 1e3 * float(np.median(ts))
        print(f"{name:34s} {times[name]:8.2f} ms", flush=True)
        return out

    timed("build_mask (full)", lambda: k2p2.build_masks_batch(*a, params=P))
    cut = timed("threshold (KDE mode + MAD)", lambda: k2p2._threshold(imgs, P))[0]

    above = torch.isfinite(imgs) & (imgs > cut[:, None, None]) & coll
    labT = timed("dbscan_labels (batch-last)",
                 lambda: dbscan_labels(above.permute(1, 2, 0), min_samples=P.min_for_cluster))
    above2 = above & (labT.permute(2, 0, 1) > 0)

    blurred = timed("gaussian blur", lambda: gaussian_blur2d(
        torch.where(above2, torch.nan_to_num(imgs), 0.0), P.ws_blur))
    timed("local maxima", lambda: k2p2._local_maxima(
        torch.where(above2, blurred, -torch.inf), P.ws_footprint, P.ws_thres))
    markers = timed("catalog markers", lambda: k2p2._rasterize_markers(
        k2p2._catalog_marker_pix(blurred, above2, cc, cr, ct, cv, P), hw, hw))
    timed("watershed (batch-last)", lambda: watershed_segment(
        blurred.permute(1, 2, 0), markers.permute(1, 2, 0), above2.permute(1, 2, 0),
        connectivity=1))
    timed("saturated map", lambda: k2p2._saturated_pixel_map(imgs, above2))
    timed("fill holes", lambda: k2p2._fill_holes_4(above2))
    return times


if __name__ == "__main__":
    main()
