"""Operations and bytes of the PSF fit kernel's launches, and the time they
bound it to on a card of ``peaks.json``: what ``psf_warm_fit_roofline``
is computed from.

A launch is (B, S, K, h, w, n_iters): B instances (one target at one
cadence each) of S stars on h x w stamps, a K-term table PRF, n_iters
damped Gauss-Newton steps.  The counts are those of the repository's
smoke run (``chip_smoke.psf_flops``, ``chip_smoke.psf_bytes``), counted
from the kernel's first design: the same count of the same work whatever
implements it.
"""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def flops(B, S, K, h, w, n_iters):
    """Floating-point operations of one launch (an FMA is 2), as (normal
    equations, rest): per iteration and for the final pass, per pixel, the
    3S(3S+1)/2 + 3S normal-equation FMAs (with the weight products); the
    rest is the weights once, per iteration and for the final pass the axis
    tables (Catmull-Rom weights and K-term taps, values and derivatives,
    per star and row/column), per pixel and star the cutoff, the K-term
    render and the Jacobian row, then the damped Cholesky and two
    triangular solves and the update, and at the end the covariance
    Cholesky and the S inverse columns."""
    P3 = 3 * S
    npix = h * w
    normal = B * (n_iters + 1) * npix * (P3 * (P3 + 1) + 3 * P3)
    axis = S * (h + w) * (64 + 16 * K + 4)
    pixel = npix * (S * (10 + 6 * K) + 1)
    chol = 2 * P3 ** 3 // 3 + 3 * P3
    step = axis + pixel + chol + 2 * P3 ** 2 + 10 * S
    final = axis + pixel + 2 * npix + chol + S * P3 ** 2
    return normal, B * (5 * npix + n_iters * step + final)


def nbytes(B, S, h, w):
    """Bytes one launch must move: images and backgrounds (float32) and the
    MOMF mask (uint8) per pixel, p0, valid (uint8) and onehot per star, and
    params, flux_ap and fluxvar out."""
    return B * (9 * h * w + 12 * S + S + 4 * S + 12 * S + 8)


def bound_s(launches, card="H100") -> float:
    """Seconds the launches take at the card's peaks, each the larger of its
    operations' time (the normal equations at the TF32 peak over 3, for
    3xTF32; the rest at the float32 peak) and its bytes' time at the HBM
    bandwidth."""
    with open(os.path.join(HERE, "peaks.json")) as fh:
        peak = json.load(fh)[card]
    total = 0.0
    for B, S, K, h, w, n_iters in launches:
        normal, rest = flops(B, S, K, h, w, n_iters)
        ops_s = normal / (peak["tf32_flops_per_s"] / 3) + rest / peak["fp32_flops_per_s"]
        total += max(ops_s, nbytes(B, S, h, w) / peak["hbm_bytes_per_s"])
    return total
