"""Corpus-scale evidence for the watershed tie-break bound, on the port.

The port's copy of ``tools/tiebreak_corpus_scale.py``, with its own copy
of the corpus, the reference composition and the FIFO flood of
``tests/test_tiebreak_corpus.py`` (random 1-3 star stamps of 21x21,
segmented by sklearn's DBSCAN, scipy's blur and a faithful re-writing of
skimage's heap flood, k2p2v2.py:344-633).  The port's masks come from
``models.k2p2.build_masks_batch(debug=True)`` in 1,000-stamp chunks on
``--device``; each is compared with the reference composition at the same
threshold, and the reference is compared with itself flooded in the other
valid tie order (LIFO insertion age, neighbours scanned in reverse).  If
the port disagrees with the FIFO flood at about the rate the LIFO flood
does, the disagreement is the plateau/ridge ambiguity of the algorithm,
not a fault of the port's rule.

The reference composition needs scikit-learn and scipy (host only).

Usage:
    python -m photometry_tpu_torch.tools.tiebreak_corpus_scale [N_STAMPS]
        [--device cuda|cpu]

Writes one JSON summary line (the JAX tool's).
"""

import argparse
import heapq
import json
import sys

import numpy as np
import torch

from ..core.engine import DEFAULT_K2P2_PARAMS
from ..device import resolve_device
from ..models.k2p2 import build_masks_batch

H = W = 21
K = 4          #: catalog slots
CHUNK = 1000   #: stamps drawn and masked at a time


def corpus(rng, n: int):
    """n random 1-3 star stamps (background-subtracted) and their padded
    catalogs, with each star's amplitude and sigma (amp 0: an empty slot)."""
    imgs = np.zeros((n, H, W), np.float32)
    cat_col = np.full((n, K), 1e9, np.float32)
    cat_row = np.full((n, K), 1e9, np.float32)
    cat_tmag = np.full((n, K), 30.0, np.float32)
    cat_valid = np.zeros((n, K), bool)
    star_amp = np.zeros((n, K), np.float64)
    star_sigma = np.zeros((n, K), np.float64)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    for i in range(n):
        n_star = int(rng.integers(1, 4))
        amps = rng.uniform(80, 4000, n_star)
        amps[::-1].sort()
        for j in range(n_star):
            r = rng.uniform(5.0, H - 6.0)
            c = rng.uniform(5.0, W - 6.0)
            s = rng.uniform(1.0, 1.6)
            imgs[i] += (amps[j] * np.exp(
                -0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / s ** 2)).astype(np.float32)
            cat_row[i, j] = r
            cat_col[i, j] = c
            cat_tmag[i, j] = rng.uniform(10.0, 14.0)  # faint: no overflow lanes
            cat_valid[i, j] = True
            star_amp[i, j] = amps[j]
            star_sigma[i, j] = s
        imgs[i] += rng.normal(0, 3.0, (H, W)).astype(np.float32)
    return imgs, cat_col, cat_row, cat_tmag, cat_valid, star_amp, star_sigma


def _flood(elev, markers, mask, nbrs, lifo: bool):
    """Vincent-Soille heap flooding: seeds pushed at their own elevation,
    neighbours labelled when pushed, the heap ordered by (elevation,
    insertion age), age FIFO or LIFO."""
    Hh, Ww = elev.shape
    labels = np.where(mask, markers, 0).astype(np.int32)
    sign = -1 if lifo else 1
    heap = []
    age = 0
    for y, x in zip(*np.nonzero((markers > 0) & mask)):
        heapq.heappush(heap, (elev[y, x], sign * age, int(y), int(x)))
        age += 1
    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab = labels[y, x]
        for dy, dx in nbrs:
            ny, nx = y + dy, x + dx
            if 0 <= ny < Hh and 0 <= nx < Ww and mask[ny, nx] and labels[ny, nx] == 0:
                labels[ny, nx] = lab
                heapq.heappush(heap, (elev[ny, nx], sign * age, ny, nx))
                age += 1
    return labels


def flood_watershed(elev, markers, mask, connectivity: int = 1):
    """skimage.segmentation.watershed re-written: FIFO ties, default
    4-connectivity (skimage's _watershed.pyx semantics)."""
    nbrs = ([(-1, 0), (1, 0), (0, -1), (0, 1)] if connectivity == 1 else
            [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)])
    return _flood(elev, markers, mask, nbrs, lifo=False)


def flood_watershed_lifo(elev, markers, mask, connectivity: int = 1):
    """The same flood with the other valid tie order: LIFO insertion age
    and the neighbours scanned in reverse.  Pixels whose label differs from
    the FIFO flood's depend on the tie order even inside the reference."""
    nbrs = ([(0, 1), (0, -1), (1, 0), (-1, 0)] if connectivity == 1 else
            [(dy, dx) for dy in (1, 0, -1) for dx in (1, 0, -1) if (dy, dx) != (0, 0)])
    return _flood(elev, markers, mask, nbrs, lifo=True)


def ref_mask(img, cut, cols, rows, tmags, valid, tr, tc, flood=flood_watershed):
    """Reference-composed mask of one stamp: sklearn DBSCAN + scipy blur +
    the flooding watershed + the 4-neighbour hole fill (k2p2v2.py:344-633).
    Returns ``(mask, found)``."""
    from scipy.ndimage import gaussian_filter, maximum_filter
    from sklearn.cluster import DBSCAN

    p = DEFAULT_K2P2_PARAMS
    above = np.isfinite(img) & (img > cut)
    lab_img = np.zeros((H, W), np.int32)
    ys, xs = np.nonzero(above)
    if len(ys):
        db = DBSCAN(eps=np.sqrt(2) + 1e-9, min_samples=p.min_for_cluster
                    ).fit(np.stack([xs, ys], axis=1))
        lab_img[ys, xs] = db.labels_ + 1
    above2 = above & (lab_img > 0)

    flux_above = np.where(above2, np.nan_to_num(img), 0.0)
    blur = gaussian_filter(flux_above.astype(np.float64), p.ws_blur, mode="mirror",
                           truncate=4.0)
    fp = np.ones((3, 3), bool)
    fp[1, 1] = False
    best = maximum_filter(blur, footprint=fp, mode="constant", cval=-np.inf)
    maxima = (blur >= best) & above2

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    markers = np.zeros((H, W), np.int32)
    for k in range(K):
        if not valid[k]:
            continue
        d2 = np.where(maxima, (xx - cols[k]) ** 2 + (yy - rows[k]) ** 2, np.inf)
        i = int(np.argmin(d2))
        if not np.isfinite(d2.flat[i]):
            continue
        dist_factor = 2.0 if tmags[k] > 7.0 else 5.0
        if np.sqrt(d2.flat[i]) < dist_factor * np.sqrt(2.0):
            markers.flat[i] = k + 1
    seg = flood(-blur, markers, above2)

    ti, tj = int(np.clip(round(tr), 0, H - 1)), int(np.clip(round(tc), 0, W - 1))
    lab = seg[ti, tj]
    mask = (seg == lab) & (lab > 0)
    found = (lab > 0) and mask.sum() >= p.min_no_pixels_in_mask
    # 4-neighbour hole fill (k2p2v2.py:546-557):
    pd = np.pad(mask.astype(float), 1)
    s = pd[:-2, 1:-1] + pd[2:, 1:-1] + pd[1:-1, :-2] + pd[1:-1, 2:]
    mask = mask | ((s > 3.8) & ~mask)
    if not found:
        mask = (np.abs(xx - tc) <= 1) & (np.abs(yy - tr) <= 1)
    return mask, found


def chunk_masks(chunk_idx: int, device):
    """Chunk ``chunk_idx`` of the corpus (numpy seed 10,000 + chunk_idx, as
    the JAX tool draws it) and the port's masks of it on ``device``.
    Returns ``(corpus arrays, build_masks_batch's output on the host)``."""
    arrays = corpus(np.random.default_rng(10_000 + chunk_idx), CHUNK)
    imgs, cat_col, cat_row, cat_tmag, cat_valid = arrays[:5]
    args = [imgs, cat_col, cat_row, cat_tmag,
            np.arange(1, K + 1, dtype=np.int64)[None].repeat(CHUNK, 0), cat_valid,
            cat_row[:, 0], cat_col[:, 0], cat_tmag[:, 0], np.ones((CHUNK, H, W), bool)]
    out = build_masks_batch(*(torch.as_tensor(a, device=device) for a in args),
                            params=DEFAULT_K2P2_PARAMS, debug=True)
    return arrays, {k: v.cpu().numpy() for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Tie-break bound of the port's masks at corpus scale.")
    ap.add_argument("n_stamps", nargs="?", type=int, default=10000)
    ap.add_argument("--device", default="cuda", help="Torch device of the masks (default: cuda).")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_total = args.n_stamps

    # "cluster pixel" denominators follow PARITY.md: pixels in the union of
    # the two masks being compared.
    agg = {"single_exact": 0, "single_total": 0, "multi_total": 0,
           "ours_diff_pix": 0, "ours_union_pix": 0, "ref_selfdiff_pix": 0, "ref_union_pix": 0,
           "flux_delta": [], "ref_self_flux_delta": []}
    done = 0
    chunk_idx = 0
    while done < n_total:
        (imgs, cat_col, cat_row, cat_tmag, cat_valid, _, _), out = chunk_masks(chunk_idx, dev)
        ours, cuts = out["mask"], out["cut"]
        t_row, t_col = cat_row[:, 0], cat_col[:, 0]
        for i in range(min(CHUNK, n_total - done)):
            args_i = (imgs[i], cuts[i], cat_col[i], cat_row[i], cat_tmag[i], cat_valid[i],
                      t_row[i], t_col[i])
            ref, _ = ref_mask(*args_i)
            nu = int((ours[i] | ref).sum())
            if nu == 0:
                continue
            ndiff = int((ours[i] ^ ref).sum())
            if int(cat_valid[i].sum()) <= 1:
                agg["single_total"] += 1
                agg["single_exact"] += int(ndiff == 0)
                continue
            agg["multi_total"] += 1
            agg["ours_diff_pix"] += ndiff
            agg["ours_union_pix"] += nu
            f_ref = float(imgs[i][ref].sum())
            if f_ref > 0:
                agg["flux_delta"].append(abs(float(imgs[i][ours[i]].sum()) - f_ref) / f_ref)
            # The reference against itself in the other tie order, through
            # the same target-label and hole-fill decoration:
            ref2, _ = ref_mask(*args_i, flood=flood_watershed_lifo)
            agg["ref_selfdiff_pix"] += int((ref ^ ref2).sum())
            agg["ref_union_pix"] += int((ref | ref2).sum())
            if f_ref > 0:
                agg["ref_self_flux_delta"].append(
                    abs(float(imgs[i][ref2].sum()) - f_ref) / f_ref)
        done += CHUNK
        chunk_idx += 1
        print(f"  {min(done, n_total)}/{n_total} stamps...", file=sys.stderr)

    fd = np.asarray(agg["flux_delta"])
    sd = np.asarray(agg["ref_self_flux_delta"])
    result = {
        "n_stamps": n_total,
        "single_star": {"stamps": agg["single_total"], "exact": agg["single_exact"]},
        "multi_star": {
            "stamps": agg["multi_total"],
            "ours_vs_flood_pixel_rate": agg["ours_diff_pix"] / max(agg["ours_union_pix"], 1),
            "flood_self_disagreement_rate":
                agg["ref_selfdiff_pix"] / max(agg["ref_union_pix"], 1),
            "ours_flux_delta_mean": float(fd.mean()) if len(fd) else None,
            "ours_flux_delta_p99": float(np.percentile(fd, 99)) if len(fd) else None,
            "flood_self_flux_delta_mean": float(sd.mean()) if len(sd) else None,
            "flood_self_flux_delta_p99": float(np.percentile(sd, 99)) if len(sd) else None,
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
