"""The background's tile modes: the plain torch path on the CPU and with
``plain``, and the tile-mode kernel (``ops/csrc/tile_mode.cu``) against it
on a card.

- On the CPU, ``tile_mode``, ``_tiled_mode`` and ``estimate_background``
  take the plain version whatever ``plain`` says; the kernel's launch count
  and the ``background_kernel_frames`` counter stay put, and no library is
  built or loaded.  The routing rule itself (kernel on a CUDA tensor unless
  ``plain``; a tile above the kernel's limit refused) is held on stand-ins.
- The ``*_on_card`` tests need a CUDA card (marker ``cuda``) and skip
  without one; run them with
  ``python -m pytest --noconftest -m cuda tests/test_torch_tilemode.py``.
  They hold the kernel's grid to ``tile_mode_plain`` on the same card
  (``tilemode.compare_to_plain``, which chip_smoke's phases use too):
  the NaN pattern exactly, values to 2e-6 (the SExtractor-mode tolerance
  of the parity tests) of the larger of the mode and the tile's mean
  |value| (the two paths round the mean alike relative to the values, so
  a mode near 0, as in the fit passes after the radial component is
  subtracted, is held to the values' scale), and every tile outside it
  must hold a pixel (or a skew ratio) within the kernel's stated rounding
  bound of a clip cut in the plain path; such tiles are counted, and
  bounded.
"""

import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from photometry_tpu_torch.ops import background, tilemode
from photometry_tpu_torch.ops._kernels import TILE_MODE
from photometry_tpu_torch.utils.profiling import StageTimer

RTOL = tilemode.RTOL


def _sky(rng, F, H, W):
    """Sky-like float32 frames and their exclusion mask: a sloped sky with
    noise, Gaussian stars (masked footprints round the brightest), NaN
    pixels, a saturated patch above the 8e4 flux cut."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (150 + 40 * xx / W + 25 * yy / H)[None] + rng.normal(0, 6, (F, H, W))
    foot = np.zeros((F, H, W), bool)
    for f in range(F):
        for amp, y0, x0 in zip(rng.uniform(50, 4e4, 40), rng.uniform(0, H, 40),
                               rng.uniform(0, W, 40)):
            ys = slice(max(int(y0) - 9, 0), int(y0) + 10)
            xs = slice(max(int(x0) - 9, 0), int(x0) + 10)
            r2 = (yy[ys, xs] - y0) ** 2 + (xx[ys, xs] - x0) ** 2
            img[f, ys, xs] += amp * np.exp(-r2 / (2 * 1.5 ** 2))
            if amp > 5e3:
                foot[f, ys, xs] |= r2 < 36
    img = img.astype(np.float32)
    img[:, H // 3:H // 3 + 6, W // 2:W // 2 + 9] = 1.2e5
    img[rng.uniform(size=img.shape) < 0.005] = np.nan
    mask = foot | ~np.isfinite(img) | (img > 8e4) | (img < 0)
    return img, mask


def _cases(rng):
    """(name, img, mask, tile) cases: 64-px tiles on frames that do not
    divide into them, with special tiles in frame 0; 16-px tiles (256
    pixels, the bisection median's smallest) and 8-px tiles (the sorting
    median)."""
    img, mask = _sky(rng, 3, 300, 453)
    t = 64
    mask[0, :t, :t] = True                                            # all excluded
    mask[0, :t, t:2 * t] |= rng.uniform(size=(t, t)) < 0.55           # below min_fraction
    img[0, t:2 * t, :t], mask[0, t:2 * t, :t] = 212.5, False          # constant: std 0
    skew = np.full((t, t), 100.0, np.float32)
    tail = rng.uniform(size=(t, t)) < 0.4
    skew[tail] = 100 + rng.exponential(10, tail.sum())
    img[0, t:2 * t, t:2 * t], mask[0, t:2 * t, t:2 * t] = skew, False  # skewed
    img[1, :t, :t] = 0.0
    img[1, :t // 2, :t] = -0.0                                        # signed zeros
    mask[1, :t, :t] = False
    yy, xx = np.mgrid[0:300, 0:453].astype(np.float32)
    img[2] -= 150 + 40 * xx / 453 + 25 * yy / 300                    # the sky off: modes near 0
    small, smask = _sky(rng, 2, 70, 90)
    return [("sky64", img, mask, 64), ("sky16", small, smask, 16), ("sky8", small, smask, 8)]


def _compare(got, want, img, mask, tile):
    """``tilemode.compare_to_plain``: NaN pattern exact, every tile outside
    RTOL explained by a pixel near a clip cut.  Returns (tiles compared,
    tiles outside RTOL)."""
    agree = tilemode.compare_to_plain(got, want, img, mask, tile)
    assert agree.same_nan and not agree.unexplained, agree
    return agree.compared, agree.outside


# -- the CPU: the plain path ------------------------------------------------------

def test_tile_mode_on_cpu_is_the_plain_path():
    """On the CPU ``tile_mode`` is ``tile_mode_plain`` bit for bit, with
    ``plain`` or without; no launch, no counter, no library loaded."""
    img, mask = _sky(np.random.default_rng(0), 2, 130, 150)
    img, mask = torch.from_numpy(img), torch.from_numpy(mask)
    before = TILE_MODE.launches
    walls = {}
    with StageTimer(walls).recording():
        want = tilemode.tile_mode_plain(img, mask, 32, 0.5)
        for plain in (False, True):
            got = tilemode.tile_mode(img, mask, 32, 0.5, plain=plain)
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert TILE_MODE.launches == before and "background_kernel_frames" not in walls
    assert TILE_MODE._lib is None
    assert want.shape == (2, 5, 5) and want.isfinite().any()
    with pytest.raises(ValueError):
        tilemode.tile_mode_cuda(img, mask, 32, 0.5)


@pytest.mark.parametrize("plain", [False, True])
def test_estimate_background_on_cpu_takes_the_plain_tile_modes(plain):
    """``estimate_background`` (and so ``_tiled_mode``) on the CPU gives the
    same background with ``plain`` or without, from the plain tile modes,
    and counts no frame in ``background_kernel_frames``."""
    img, _ = _sky(np.random.default_rng(1), 2, 96, 112)
    img = torch.from_numpy(np.nan_to_num(img))
    before = TILE_MODE.launches
    calls = []
    orig = tilemode.tile_mode_plain

    def spy(*a, **kw):
        calls.append(a[2])
        return orig(*a, **kw)

    walls = {}
    with pytest.MonkeyPatch.context() as mp, StageTimer(walls).recording():
        mp.setattr(tilemode, "tile_mode_plain", spy)
        got, _ = background.estimate_background(img, tile=16, plain=plain)
    want, _ = background.estimate_background(img, tile=16)
    assert calls == [16] and TILE_MODE.launches == before
    assert walls["background_kernel_frames"] == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("device,plain,tile,route", [
    ("cuda", False, 64, "cuda"),
    ("cuda", True, 64, "plain"),
    ("cuda", False, 128, "cuda"),
    ("cuda", False, 129, "too large"),
    ("cpu", False, 64, "plain"),
    ("cpu", True, 64, "plain"),
])
def test_tile_mode_routes_by_device_plain_and_tile(monkeypatch, device, plain, tile, route):
    """The kernel takes CUDA tensors unless ``plain``; everything else takes
    the plain version.  A tile larger than the kernel's limit (the
    library's ``tile_mode_max_pixels``, 128^2) raises ``ValueError`` before
    any launch: it does not fall back."""
    taken = []
    monkeypatch.setattr(tilemode, "tile_mode_plain", lambda *a, **kw: taken.append("plain"))
    fake = types.SimpleNamespace(device=torch.device(device), to=lambda *a: fake,
                                 contiguous=lambda: fake)
    if route == "too large":
        stub = types.SimpleNamespace(tile_mode_max_pixels=lambda: 128 * 128)
        monkeypatch.setattr(TILE_MODE, "lib", lambda: stub)
        with pytest.raises(ValueError, match="16384 pixels"):
            tilemode.tile_mode(fake, fake, tile, 0.5, plain=plain)
        assert taken == []
        return
    monkeypatch.setattr(tilemode, "tile_mode_cuda", lambda *a, **kw: taken.append("cuda"))
    tilemode.tile_mode(fake, fake, tile, 0.5, plain=plain)
    assert taken == [route]


def test_importing_the_port_builds_no_tile_mode_library():
    """Importing the background modules and fitting on the CPU leaves the
    kernel's library unbuilt and unloaded."""
    import photometry_tpu_torch.prepare  # noqa: F401
    img, mask = _sky(np.random.default_rng(2), 1, 64, 64)
    tilemode.tile_mode(torch.from_numpy(img), torch.from_numpy(mask), 16, 0.5)
    assert TILE_MODE._lib is None and TILE_MODE.build_seconds is None


def test_compare_to_plain_flags_what_no_clip_cut_explains():
    """``compare_to_plain`` on the CPU: a grid equal to the plain one agrees;
    a tile moved by 1e-3, with no pixel near a clip cut, is outside RTOL and
    unexplained; one moved by less than RTOL of the tile's scale is not
    outside; a NaN where the plain grid has a value breaks the pattern."""
    img, mask = _sky(np.random.default_rng(3), 2, 100, 120)
    img, mask = torch.from_numpy(img), torch.from_numpy(mask)
    want = tilemode.tile_mode_plain(img, mask, 32, 0.5)
    agree = tilemode.compare_to_plain(want.clone(), want, img, mask, 32)
    assert agree == (True, int(want.isfinite().sum()), 0, [])
    got = want.clone()
    got[1, 2, 3] *= 1 + 1e-3
    got[0, 1, 1] *= 1 + 1e-7
    agree = tilemode.compare_to_plain(got, want, img, mask, 32)
    assert agree.same_nan and agree.outside == 1
    assert [u[:3] for u in agree.unexplained] == [(1, 2, 3)]
    got[0, 0, 0] = float("nan")
    assert not tilemode.compare_to_plain(got, want, img, mask, 32).same_nan


# -- the card: the kernel against the plain path ----------------------------------

@pytest.mark.cuda
def test_tile_mode_kernel_matches_plain_on_card():
    """The kernel's grid against ``tile_mode_plain`` on the card: sky-like
    frames of 300 x 453 (64-px tiles that do not divide them) with an
    all-excluded tile, a tile below ``min_fraction``, a constant tile, a
    skewed tile and signed zeros; 16-px and 8-px tiles; then 16 frames of
    2048 x 2048.  Tiles outside RTOL must each hold a pixel within the
    rounding bound of a clip cut, and are at most 1% of the tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    big = torch.zeros(1, 258, 258, device="cuda")
    with pytest.raises(ValueError):
        tilemode.tile_mode(big, big.isnan(), 129, 0.5)
    rng = np.random.default_rng(7)
    total = flipped = 0
    for name, img, mask, tile in _cases(rng):
        img, mask = torch.as_tensor(img, device="cuda"), torch.as_tensor(mask, device="cuda")
        before = TILE_MODE.launches
        got = tilemode.tile_mode_cuda(img, mask, tile, 0.5)
        torch.cuda.synchronize()
        assert TILE_MODE.launches == before + 1
        want = tilemode.tile_mode_plain(img, mask, tile, 0.5)
        assert torch.equal(got.view(torch.int32),
                           tilemode.tile_mode_cuda(img, mask, tile, 0.5).view(torch.int32))
        n, off = _compare(got, want, img, mask, tile)
        print(f"{name}: {off} of {n} tiles outside rtol {RTOL}")
        total, flipped = total + n, flipped + off
        if name == "sky64":
            g = got.cpu().numpy()
            assert np.isnan(g[0, 0, 0]) and np.isnan(g[0, 0, 1])   # excluded, < min_fraction
            assert g[0, 1, 0] == np.float32(212.5) and g[0, 1, 1] == np.float32(100.0)
            assert g[1, 0, 0] == 0.0
    img, mask = _sky(rng, 16, 2048, 2048)
    img, mask = torch.as_tensor(img, device="cuda"), torch.as_tensor(mask, device="cuda")
    got = tilemode.tile_mode_cuda(img, mask, 64, 0.5)
    assert torch.equal(got.view(torch.int32),
                       tilemode.tile_mode_cuda(img, mask, 64, 0.5).view(torch.int32))
    n, off = _compare(got, tilemode.tile_mode_plain(img, mask, 64, 0.5), img, mask, 64)
    print(f"sky 16 x 2048^2: {off} of {n} tiles outside rtol {RTOL}")
    total, flipped = total + n, flipped + off
    assert flipped <= 0.01 * total, (flipped, total)


@pytest.mark.cuda
def test_estimate_background_takes_the_kernel_on_card():
    """On a card ``estimate_background`` fits every tile grid with the kernel
    (one launch a ``bkgiters`` pass, the frames counted once in
    ``background_kernel_frames``) and with ``plain`` none (0 counted); the backgrounds
    agree to 1e-4 of their median."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img, mask = _sky(np.random.default_rng(8), 4, 512, 640)
    img = torch.as_tensor(np.nan_to_num(img), device="cuda")
    radius = np.hypot(*np.mgrid[0:512, 0:640].astype(np.float64)).astype(np.float32) + 3000
    before = TILE_MODE.launches
    walls = {}
    with StageTimer(walls).recording():
        got, _ = background.estimate_background(img, radius_image=radius, radial_cutoff=2400,
                                                radial_pixel_step=15, tile=64)
    assert TILE_MODE.launches == before + 3 and walls["background_kernel_frames"] == 4
    walls = {}
    with StageTimer(walls).recording():
        want, _ = background.estimate_background(img, radius_image=radius, radial_cutoff=2400,
                                                 radial_pixel_step=15, tile=64, plain=True)
    assert TILE_MODE.launches == before + 3 and walls["background_kernel_frames"] == 0
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    gap = np.nanmax(np.abs(got - want)) / np.nanmedian(np.abs(want))
    print(f"estimate_background kernel vs plain: max |diff| / median {gap:.3g}")
    assert gap <= 1e-4
