"""Port parity of the flux-only stamp extraction (the last TPU kernel).

The port's ``stamp_extract_flux`` on CPU tensors (its plain version)
against the JAX tool ``tools/pallas_extract_demo.py:pallas_extract_flux``
run by its Pallas kernel in interpret mode, at the JAX test's rtol 1e-5
(float32 sums in another order), with the same ``ValueError`` domain.
Mask pixels off the image's bottom or right edge are dropped by both.
The CUDA kernel is held against the plain version on a card by
tests/test_torch_import.py (marked ``cuda``), which imports no JAX.
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_parity import n, t

from photometry_tpu_torch.ops import stamp_flux as sf
from photometry_tpu_torch.ops.bandext import band_sums_plain

_spec = importlib.util.spec_from_file_location(
    "pallas_extract_demo",
    os.path.join(os.path.dirname(__file__), "..", "tools", "pallas_extract_demo.py"))
_demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_demo)

RTOL = 1e-5


def _jax(images, masks, r0s, c0s, h, w):
    return np.asarray(_demo.pallas_extract_flux(images, masks, r0s, c0s, h, w, interpret=True))


def _port(images, masks, r0s, c0s, h, w):
    return n(sf.stamp_extract_flux(t(images), t(masks), t(r0s), t(c0s), h, w))


def _demo_test_inputs():
    """tests/test_pallas_extract_demo.py's inputs."""
    rng = np.random.default_rng(0)
    T, H, W = 16, 256, 256
    N, h, w = 5, 8, 8
    images = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    images[2, 10, 10] = np.nan
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    r0s[0], c0s[0] = 8, 8
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[0, 2, 2] = True
    return images, masks, r0s, c0s, h, w


def _edge_inputs(N, h):
    """Stamps flush with and running past the bottom and right edges, NaN
    and ±inf pixels, an all-false mask and a cadence whose in-mask pixels
    are all NaN."""
    rng = np.random.default_rng(N)
    T, H, W = 8, 40, 256
    images = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    images[rng.uniform(size=images.shape) < 0.01] = np.nan
    images[1, 20, :] = np.inf
    images[2, :, 100] = -np.inf
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - h, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, h)) < 0.5
    r0s[0], c0s[0] = H - h, W - h                 # flush with both edges
    if N > 1:
        r0s[1], c0s[1] = H - 3, W - 2             # running past both
        masks[1, :3, :2] = True
    if N > 2:
        masks[2] = False                          # all-false mask: NaN everywhere
    if N > 3:
        masks[3] = False
        masks[3, 1, 1] = masks[3, 0, 2] = True
        images[5, r0s[3] + 1, c0s[3] + 1] = np.nan    # all in-mask pixels NaN
        images[5, r0s[3], c0s[3] + 2] = np.nan
    return images, masks, r0s, c0s, h, h


def test_matches_pallas_on_its_test_inputs():
    args = _demo_test_inputs()
    got, want = _port(*args), _jax(*args)
    assert got.shape == want.shape == (5, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("N,h", [(1, 1), (7, 17), (9, 17), (4, 33)])
def test_edges_and_missing_values_match_pallas(N, h):
    args = _edge_inputs(N, h)
    got, want = _port(*args), _jax(*args)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)
    if N > 3:
        assert np.isnan(got[2]).all() and np.isnan(got[3, 5]) and np.isfinite(got[3, 4])
    # the stamps running past the edges keep only their in-image pixels:
    images, masks, r0s, c0s = args[:4]
    H, W = images.shape[1:]
    k = min(1, N - 1)
    sub = images[:, r0s[k]:r0s[k] + h, c0s[k]:c0s[k] + h]
    m = masks[k][:sub.shape[1], :sub.shape[2]]
    vals = np.where(m & np.isfinite(sub), sub, 0.0).sum(axis=(1, 2), dtype=np.float64)
    any_ = (m & np.isfinite(sub)).any(axis=(1, 2))
    np.testing.assert_allclose(got[k], np.where(any_, vals, np.nan), rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("case", ["T not a multiple of 8", "window taller than image",
                                  "window wider than image"])
def test_value_errors_match_pallas(case):
    images, masks, r0s, c0s, h, w = _demo_test_inputs()
    if case == "T not a multiple of 8":
        images = images[:12]
    elif case == "window taller than image":
        images, h = images[:, :20], 14                # hp = 24 > 20
        masks = np.ones((5, 14, 8), bool)
        r0s[:] = 0
    else:
        images, w = images[:, :, :130], 8             # wp = 256 > 130
        c0s[:] = 0
    for fn in (_jax, _port):
        with pytest.raises(ValueError):
            fn(images, masks, r0s, c0s, h, w)


def test_negative_corners_are_outside_the_domain():
    images, masks, r0s, c0s, h, w = _demo_test_inputs()
    r0s[2] = -1
    with pytest.raises(ValueError, match="negative"):
        _port(images, masks, r0s, c0s, h, w)
    with pytest.raises(ValueError):
        _port(images, masks[:, :4], r0s, c0s, h, w)   # masks not (N, h, w)


def test_plain_chunks_and_band_sums_agree(monkeypatch):
    """Target chunks of the plain version do not change it, and on stamps
    inside the image it equals the band extraction's flux and finite-count
    sums, where(n_fin < 0.5, NaN, total) (chip_smoke.py's cross-check)."""
    images, masks, r0s, c0s, h, w = _edge_inputs(9, 17)
    r0s, c0s = np.minimum(r0s, 40 - h), np.minimum(c0s, 256 - w)
    want = _port(images, masks, r0s, c0s, h, w)
    monkeypatch.setattr(sf, "_PLAIN_BLOCK", 8 * h * w * 2)
    np.testing.assert_array_equal(_port(images, masks, r0s, c0s, h, w), want)
    zeros = np.zeros_like(images)
    Q = n(band_sums_plain(t(images), t(zeros), t(zeros), t(zeros.astype(np.uint8)), t(masks),
                          t(r0s), t(c0s)))
    band = np.where(Q[:, 1] < 0.5, np.nan, Q[:, 0])
    np.testing.assert_allclose(want, band, rtol=RTOL, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(want), np.isnan(band))


def _sector_bytes_per_cadence(masks, r0s, c0s, width, T=3, sector=32):
    """chip_smoke.stamp_sector_bytes less its once-only bytes, per cadence."""
    from chip_smoke import stamp_sector_bytes
    masks = np.asarray(masks, bool)
    N, h, w = masks.shape
    got = stamp_sector_bytes(masks, np.asarray(r0s), np.asarray(c0s), T, width, sector=sector)
    once = N * h * w + 8 * N + 4 * N * T
    assert (got - once) % T == 0
    return (got - once) // T


@pytest.mark.parametrize("case,want", [
    ("one pixel", 32),
    ("8 aligned pixels", 32),
    ("9 pixels", 64),
    ("two targets share a sector", 32),
    ("a pixel past the right edge", 32),
    ("9 pixels in one 64-byte segment", 64),
])
def test_sector_bound_counts_sectors_once(case, want):
    """The phase-2d sector bound: whole 32-byte sectors (8 float32 pixels of
    a row, aligned in the frame), each counted once per cadence however
    many windows read it, and nothing for pixels beyond the frame; with
    64-byte segments, the segments."""
    width = 64
    if case == "9 pixels in one 64-byte segment":
        assert _sector_bytes_per_cadence(np.ones((1, 1, 9)), [2], [16], width, sector=64) == want
        return
    if case == "one pixel":
        masks, r0s, c0s = np.ones((1, 1, 1)), [3], [5]
    elif case == "8 aligned pixels":
        masks, r0s, c0s = np.ones((1, 1, 8)), [2], [16]
    elif case == "9 pixels":
        masks, r0s, c0s = np.ones((1, 1, 9)), [2], [16]
    elif case == "two targets share a sector":
        masks = np.zeros((2, 2, 4), bool)
        masks[0, 1, :2] = True                    # row 5, cols 8-9
        masks[1, 0, 2:] = True                    # row 5, cols 13-14
        r0s, c0s = [4, 5], [8, 11]
    else:
        masks = np.zeros((1, 1, 4), bool)
        masks[0, 0, [0, 3]] = True                # col 62 inside, col 65 past the edge
        r0s, c0s = [7], [62]
    assert _sector_bytes_per_cadence(masks, r0s, c0s, width) == want


def test_frame_order_puts_rows_back():
    """stamp_flux_cuda's host steps on the CPU, the plain version standing in
    for the kernel: the targets reach it in frame order (row-major corners)
    and its rows come back in the caller's order."""
    images, masks, r0s, c0s, h, w = _edge_inputs(9, 17)
    keys = []

    def kernel(im, m, r, c):
        keys.append(n(r).astype(np.int64) * im.shape[2] + n(c))
        return sf.stamp_flux_plain(im, m, r, c)

    args = [t(a) for a in (images, masks, r0s, c0s)]
    got = sf.in_frame_order(kernel, *args)
    assert np.all(np.diff(keys[0]) >= 0) and not np.all(np.diff(r0s.astype(np.int64)
                                                              * 256 + c0s) >= 0)
    np.testing.assert_array_equal(n(got), n(sf.stamp_flux_plain(*args)))
