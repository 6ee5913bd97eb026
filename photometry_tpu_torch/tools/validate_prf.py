"""
Validate TESS PRF calibration ``.mat`` files against the reference method.

The port's copy of ``tools/validate_prf.py``.  The port's table-PRF path
(``models/prf.py``: the ``.mat`` loader -> IDW combination -> the
pixel-integrated table -> the SVD-separable Catmull-Rom render) is held in
the tests against ``RectBivariateSpline(...).integral``, the reference's
exact evaluation (``photometry/psf.py:119,137-147``), on synthetic PRFs;
this tool closes the gap on a deployment that has the real calibration
products:

    python -m photometry_tpu_torch.tools.validate_prf /path/to/psf_dir \\
        --sector 1 --camera 3 --ccd 2 [--device cuda|cpu]

It reports, for five stars on the stamp:
  - the SVD separability of the interpolated table (rank at the 1e-5
    truncation, residual of the truncated reconstruction);
  - max |deviation| of ``PRF.integrate_to_image`` on ``--device`` from the
    RectBivariateSpline pixel-box integrals, relative to the peak;
  - total-flux conservation.

Exit code 0 when the deviation is within --tol (default 2e-3 of the peak,
the tests' tolerance), 1 otherwise.
"""

import argparse
import sys

import numpy as np
import torch

from ..models.prf import PRF


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Validate PRF .mat files against RectBivariateSpline.integral "
                    "(reference psf.py).")
    parser.add_argument("psf_path", help=".mat file or directory of them")
    parser.add_argument("--sector", type=int, default=1)
    parser.add_argument("--camera", type=int, default=1)
    parser.add_argument("--ccd", type=int, default=1)
    parser.add_argument("--stamp", type=int, nargs=4, default=(1000, 1015, 1000, 1015),
                        metavar=("R0", "R1", "C0", "C1"),
                        help="CCD stamp whose centre position selects the "
                             "interpolated PRF (default mid-CCD 15x15).")
    parser.add_argument("--tol", type=float, default=2e-3,
                        help="Max allowed |deviation| / peak (default 2e-3).")
    parser.add_argument("--device", default="cuda",
                        help="Torch device of the render (default: cuda).")
    return parser.parse_args(argv)


def validate(args) -> dict:
    """The report's numbers: ``rank``, ``sep_resid``, ``dev``, ``flux_err``,
    and the render (``got``) beside the spline integrals (``want``)."""
    from scipy.interpolate import RectBivariateSpline
    from scipy.io import loadmat

    prf = PRF.from_mat(args.psf_path, sector=args.sector, camera=args.camera, ccd=args.ccd,
                       stamp=tuple(args.stamp), device=args.device)
    os_ = int(round(prf.oversample))
    table = np.asarray(prf.iprf)

    u, s, vt = np.linalg.svd(table, full_matrices=False)
    k = int(np.sum(s > 1e-5 * s[0]))
    recon = (u[:, :k] * s[:k]) @ vt[:k]
    sep_resid = float(np.abs(recon - table).max() / np.abs(table).max())
    print(f"table {table.shape}, oversample {os_}; SVD rank {k} at 1e-5 "
          f"truncation, reconstruction residual {sep_resid:.2e} of peak")

    # Reference comparator: the spline over the RAW normalised IDW-combined
    # grid (the reference's RectBivariateSpline input, psf.py:100-119)
    # integrated over each pixel box, not over the pixel-integrated table
    # (that would integrate twice).
    mat = loadmat(prf.info["file"])["prfStruct"]
    prf_x = np.asarray(mat["prfColumn"][0][0], np.float64).ravel()
    prf_y = np.asarray(mat["prfRow"][0][0], np.float64).ravel()
    dx = float(np.median(np.diff(prf_x)))
    dy = float(np.median(np.diff(prf_y)))
    ref_column = prf.info["ref_column"]
    ref_row = prf.info["ref_row"]
    raw = np.zeros((len(prf_y), len(prf_x)), np.float64)
    for i in range(len(mat["values"][0])):
        sub = np.asarray(mat["values"][0][i], np.float64)
        crval1p = float(np.squeeze(mat["ccdColumn"][0][i]))
        crval2p = float(np.squeeze(mat["ccdRow"][0][i]))
        raw += sub / max(np.hypot(ref_column - crval1p, ref_row - crval2p), 1e-6)
    raw /= np.nansum(raw) * dx * dy

    h = w = args.stamp[1] - args.stamp[0]
    spl = RectBivariateSpline(prf_x, prf_y, raw.T)  # (column, row) axes

    rng = np.random.default_rng(0)
    stars = np.column_stack([rng.uniform(2, h - 3, 5), rng.uniform(2, w - 3, 5),
                             rng.uniform(100, 5000, 5)])
    want = np.zeros((h, w))
    for i in range(h):
        for j in range(w):
            for row_s, col_s, f in stars:
                cc, rc = j - col_s, i - row_s
                want[i, j] += f * spl.integral(cc - 0.5, cc + 0.5, rc - 0.5, rc + 0.5)
    got = prf.integrate_to_image(torch.as_tensor(stars, dtype=torch.float32, device=prf.device),
                                 (h, w), cutoff_radius=None).cpu().numpy()
    peak = float(want.max())
    dev = float(np.abs(got - want).max() / peak)
    flux_err = float(abs(got.sum() - want.sum()) / want.sum())
    print(f"max |render - spline.integral| = {dev:.2e} of peak "
          f"(tolerance {args.tol:g}); total-flux error {flux_err:.2e}")
    return {"rank": k, "sep_resid": sep_resid, "dev": dev, "flux_err": flux_err,
            "got": got, "want": want}


def main(argv=None) -> int:
    args = parse_args(argv)
    if validate(args)["dev"] > args.tol:
        print("FAIL: deviation exceeds tolerance — check SVD truncation "
              "(models/prf.py _svd_factors tol) for this PRF.")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
