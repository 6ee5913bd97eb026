"""
Cross-validate the port's ``ops.registration.ecc_align`` against OpenCV's
``findTransformECC``.

The port's copy of ``tools/validate_ecc.py``.  The reference's jitter
accuracy comes from ``cv2.findTransformECC`` (reference
image_motion.py:236), with sub-0.01 px agreement as the bar.  Both solvers
run on one corpus of preprocessed synthetic star fields (translation,
euclidian and affine warps, noiseless and noisy); the port's solver runs
on ``--device``.  The tool reports:

- the max |delta| between the two solvers' warp-matrix entries per case;
- the shared ECC objective at both solutions: both solvers maximise the
  same correlation, so equal objectives mean that a remaining parameter
  delta is the objective's indeterminacy under noise, not a solver error.

Usage::

    python -m photometry_tpu_torch.tools.validate_ecc [--device cuda|cpu]

Exit code 0 when the noiseless corpus agrees within 0.01 and the noisy
one's objectives within 1e-4; 1 otherwise, or when cv2 does not import.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.registration import ecc_align, prepare_flux, warp_params_to_matrix


def starfield(H=64, W=64, shift=(0.0, 0.0), theta=0.0, noise=0.0,
              seed=3, nstars=12, noise_seed=None):
    """Gaussian star field with a rigid shift/rotation applied to the star
    positions (not a resampled image: positions move exactly)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.full((H, W), 100.0)
    pos = rng.uniform(8, H - 8, (nstars, 2))
    cy, cx = H / 2, W / 2
    c, s = np.cos(theta), np.sin(theta)
    for r0, c0 in pos:
        x0, y0 = c0 - cx, r0 - cy
        cc = cx + c * x0 - s * y0 + shift[0]
        rr = cy + s * x0 + c * y0 + shift[1]
        img += 5000 * np.exp(-0.5 * ((yy - rr) ** 2 + (xx - cc) ** 2) / 1.5 ** 2)
    if noise:
        nrng = np.random.default_rng(seed if noise_seed is None else noise_seed)
        img += nrng.normal(0, noise, img.shape)
    return img.astype(np.float32)


def ecc_objective(ref, img, M):
    """The shared ECC correlation at warp M (ecc_align's geometry: bilinear
    sampling, out-of-bounds warped pixels excluded from the support, as
    OpenCV's warped input mask does, and the static 2-px frame trim)."""
    H, W = ref.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    wx = M[0, 0] * xx + M[0, 1] * yy + M[0, 2]
    wy = M[1, 0] * xx + M[1, 1] * yy + M[1, 2]
    inb = (wx >= 0) & (wx <= W - 1.001) & (wy >= 0) & (wy <= H - 1.001)
    wx = np.clip(wx, 0, W - 1.001)
    wy = np.clip(wy, 0, H - 1.001)
    x0 = np.floor(wx).astype(int)
    y0 = np.floor(wy).astype(int)
    tx, ty = wx - x0, wy - y0
    w = (img[y0, x0] * (1 - tx) * (1 - ty) + img[y0, x0 + 1] * tx * (1 - ty)
         + img[y0 + 1, x0] * (1 - tx) * ty + img[y0 + 1, x0 + 1] * tx * ty)
    valid = np.ones((H, W))
    valid[:2] = 0
    valid[-2:] = 0
    valid[:, :2] = 0
    valid[:, -2:] = 0
    valid *= inb

    def norm(v):
        n = valid.sum()
        m = (v * valid).sum() / n
        v0 = (v - m) * valid
        return v0 / np.sqrt((v0 * v0).sum())

    return float((norm(np.asarray(ref, np.float64)) * norm(np.asarray(w, np.float64))).sum())


def cv2_ecc(ref, img, mode, eps=1e-10, max_iters=20000):
    """OpenCV's solution on the SAME preprocessed inputs (gaussFiltSize=1,
    so neither solver blurs; the reference passes 5, which blurs inside cv2
    and would compare different objectives)."""
    import cv2
    wm = {"translation": cv2.MOTION_TRANSLATION, "euclidian": cv2.MOTION_EUCLIDEAN,
          "affine": cv2.MOTION_AFFINE}[mode]
    warp = np.eye(2, 3, dtype=np.float32)
    crit = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, max_iters, eps)
    cc, warp = cv2.findTransformECC(ref, img, warp, wm, crit, np.ones(img.shape, np.uint8), 1)
    return np.asarray(warp, np.float64), float(cc)


# (dx, dy, theta, noise_sigma); noise is drawn independently in ref and img.
CASES = [
    (0.8, -0.5, 0.0, 0.0),
    (0.31, 0.47, 0.004, 0.0),
    (-2.0, 0.3, 0.002, 0.0),
    (1.6, 2.2, 0.0, 2.0),
    (1.0, -0.7, 0.01, 2.0),
    (-2.0, 0.3, 0.0, 5.0),
]


def run_corpus(modes=("translation", "euclidian", "affine"), n_iters=150, verbose=True,
               device="cuda", opencv=True):
    """One dict row per (mode, case): the port's ``params`` and objective;
    with ``opencv``, OpenCV's solution beside them (the JAX tool's keys),
    the cases solved by OpenCV on a thread each (it releases the GIL)."""
    dev = resolve_device(device)
    rows, inputs = [], []
    for mode in modes:
        for i, (dx, dy, th, noise) in enumerate(CASES):
            if mode == "translation":
                th = 0.0
            ref = starfield(seed=3 + i, noise=noise, noise_seed=100 + i)
            img = starfield(shift=(dx, dy), theta=th, seed=3 + i, noise=noise,
                            noise_seed=200 + i)
            pref_t = prepare_flux(torch.as_tensor(ref, device=dev))
            pimg_t = prepare_flux(torch.as_tensor(img, device=dev))
            p, _cc = ecc_align(pref_t, pimg_t, mode=mode, n_iters=n_iters)
            Mo = warp_params_to_matrix(p, mode).cpu().numpy().astype(np.float64)
            pref, pimg = pref_t.cpu().numpy(), pimg_t.cpu().numpy()
            rows.append(dict(mode=mode, case=i, noise=noise, params=p.cpu().numpy(),
                             obj_ours=ecc_objective(pref, pimg, Mo)))
            inputs.append((pref, pimg, Mo))
    if not opencv:
        return rows
    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        solved = list(pool.map(cv2_ecc, [a[0] for a in inputs], [a[1] for a in inputs],
                               [row["mode"] for row in rows]))
    for row, (pref, pimg, Mo), (Mc, _ccc) in zip(rows, inputs, solved):
        fo, fc = row["obj_ours"], ecc_objective(pref, pimg, Mc)
        row.update(max_delta=float(np.abs(Mo - Mc).max()),
                   delta_translation=float(np.abs(Mo[:, 2] - Mc[:, 2]).max()),
                   obj_cv2=fc, obj_delta=fo - fc)
        if verbose:
            print(f"{row['mode']:12s} case{row['case']} noise={row['noise']:>4}: "
                  f"max|dM|={row['max_delta']:.3e} "
                  f"|d t|={row['delta_translation']:.3e} "
                  f"obj {fo:.6f} vs {fc:.6f} ({row['obj_delta']:+.1e})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Cross-validate ecc_align against OpenCV.")
    ap.add_argument("--device", default="cuda", help="Torch device of ecc_align (default: cuda).")
    args = ap.parse_args(argv)
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("cv2 not available — cannot cross-validate")
        return 1
    rows = run_corpus(device=args.device)
    noiseless = [r for r in rows if r["noise"] == 0]
    noisy = [r for r in rows if r["noise"] > 0]
    print()
    print("noiseless corpus: max |dM| = %.3e  (bar: < 0.01)"
          % max(r["max_delta"] for r in noiseless))
    print("noisy corpus:     max |dt| = %.3e, max |d obj| = %.1e"
          % (max(r["delta_translation"] for r in noisy),
             max(abs(r["obj_delta"]) for r in noisy)))
    ok = (max(r["max_delta"] for r in noiseless) < 0.01
          and max(abs(r["obj_delta"]) for r in noisy) < 1e-4)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
