"""Port parity of ECC registration and the motion model's kernel estimation.

JAX (``photometry_tpu/ops/registration.py``, ``core/motion.py``) against
the port (``photometry_tpu_torch/ops/registration.py``, ``core/motion.py``)
on the CPU, on the star fields of tests/test_imagemotion.py and the frames
of tests/test_prepare.py's movement-kernel sim.

Tolerances, all float32 on both sides:

- ``scharr`` of raw frames: a few float32 ulps of the input's scale
  (atol 4e-7 x max|x|): the nine taps are summed in another order, and
  where the gradient cancels to ~0 only that rounding is left (measured
  2.2e-5 on noise up to 429, 3.1e-4 on the star field up to 5,294: about
  6e-8 x max|x|).
- ``prepare_flux``: atol 2e-6 on gradients of order 1.
  ``log10`` differs by one ulp between XLA:CPU and torch in about a third
  of the pixels, and the normalised log image (range 2) carries that ulp
  (~2.4e-7) through 3x3 sums of weights with |w| summing to 1 per axis;
  the gradient magnitude then differs by a few ulps of order-1 values.
  Measured: 1.5e-7 to 1.9e-7.
- ``ecc_align``: parameters within 2e-5 (px, or rad / matrix entries),
  cc within 1e-4.  The per-frame sums run over 4,096 pixels in another
  order (and XLA contracts some products into FMAs); the fixed point
  moves by that noise only.  Measured: 4.8e-7 to 3.2e-6 on the parameters,
  1.1e-5 to 2.3e-5 on cc (the spread is torch's thread count).
- The batched form against per-frame calls: 1e-5 (summation order of
  another tensor layout; measured 1.2e-6).
- Movement kernels through ``MotionModel`` and stage 6: 2e-5 px
  (measured 1.3e-6 to 1.9e-6).
"""

import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_imagemotion import _starfield

from photometry_tpu.core.motion import MotionModel as JaxMotion
from photometry_tpu.ops.filters import scharr as jax_scharr
from photometry_tpu.ops.registration import ecc_align as jax_ecc
from photometry_tpu.ops.registration import prepare_flux as jax_prepare_flux
from photometry_tpu.sim.simulator import SimConfig, simulate_sector
from photometry_tpu_torch.core import motion as motion_mod
from photometry_tpu_torch.core.motion import MotionModel
from photometry_tpu_torch.ops.filters import scharr
from photometry_tpu_torch.ops.registration import (N_PARAMS, ecc_align, ecc_align_batch,
                                                   prepare_flux, warp_params_to_matrix)

FLUX_ATOL = 2e-6
P_ATOL, CC_ATOL = 2e-5, 1e-4


def _frames():
    rng = np.random.default_rng(8)
    noisy = rng.normal(300, 40, (37, 45)).astype(np.float32)
    noisy[4, 9] = noisy[0, 0] = noisy[36, 20] = noisy[18, 44] = np.nan
    return {"noise with NaN pixels": noisy,
            "constant frame": np.full((24, 30), 7.0, np.float32),
            "star field": _starfield()}


@pytest.mark.parametrize("name", list(_frames()))
def test_scharr_and_prepare_flux_match_jax(name):
    x = _frames()[name]
    a, b = np.asarray(jax_scharr(x)), n(scharr(t(x)))
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a))    # a NaN spoils its 3x3
    np.testing.assert_allclose(b, a, rtol=0, atol=4e-7 * np.nanmax(np.abs(x)), equal_nan=True)
    np.testing.assert_allclose(n(prepare_flux(t(x))), np.asarray(jax_prepare_flux(x)),
                               rtol=0, atol=FLUX_ATOL)


def test_prepare_flux_is_per_frame():
    frames = np.stack([_frames()["noise with NaN pixels"], 5 * _frames()["noise with NaN pixels"]])
    got = n(prepare_flux(t(frames)))
    for k in range(2):
        np.testing.assert_allclose(got[k], n(prepare_flux(t(frames[k]))), rtol=0, atol=1e-7)


# (mode, shift (dx, dy), theta): tests/test_imagemotion.py's cases
CASES = [("translation", (0.8, -0.5), 0.0), ("translation", (1.6, 2.2), 0.0),
         ("translation", (-2.0, 0.3), 0.0), ("euclidian", (1.0, -0.7), 0.01),
         ("affine", (0.5, 0.9), 0.0)]


def _truth_check(mode, p, shift, theta):
    """tests/test_imagemotion.py's bounds against the injected motion."""
    if mode == "translation":
        np.testing.assert_allclose(p, shift, atol=0.02)
    elif mode == "euclidian":
        assert p[2] == pytest.approx(theta, abs=0.003)
    else:
        m = p.reshape(2, 3)
        np.testing.assert_allclose(m[:, :2], np.eye(2), atol=0.02)
        np.testing.assert_allclose(m[:, 2], shift, atol=0.1)


@pytest.mark.parametrize("mode,shift,theta", CASES)
def test_ecc_align_matches_jax_and_truth(mode, shift, theta):
    ref, img = _starfield(), _starfield(shift=shift, theta=theta)
    pj, cj = jax_ecc(jax_prepare_flux(ref), jax_prepare_flux(img), mode=mode)
    pt, ct = ecc_align(prepare_flux(t(ref)), prepare_flux(t(img)), mode=mode)
    assert pt.shape == (N_PARAMS[mode],) and pt.dtype == torch.float32
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=0, atol=P_ATOL)
    assert float(ct) == pytest.approx(float(cj), abs=CC_ATOL)
    _truth_check(mode, n(pt), shift, theta)
    assert float(ct) > 0.7


@pytest.mark.parametrize("mode", ["translation", "euclidian", "affine"])
def test_ecc_align_with_mask_matches_jax(mode):
    """A validity mask (a bad column and a dead corner) through both packages."""
    ref, img = _starfield(), _starfield(shift=(0.9, -0.6), theta=0.005)
    mask = np.ones(ref.shape, bool)
    mask[:, 30] = False
    mask[50:, 50:] = False
    pj, cj = jax_ecc(jax_prepare_flux(ref), jax_prepare_flux(img), mode=mode, mask=mask)
    pt, ct = ecc_align(prepare_flux(t(ref)), prepare_flux(t(img)), mode=mode, mask=t(mask))
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=0, atol=P_ATOL)
    assert float(ct) == pytest.approx(float(cj), abs=CC_ATOL)


@pytest.mark.parametrize("mode", ["translation", "euclidian", "affine"])
def test_batch_matches_single_frames(mode):
    """Frames of one batch reduce over their own pixels only: the batched
    form equals per-frame calls up to summation order, with a per-frame mask."""
    ref = prepare_flux(t(_starfield()))
    imgs = prepare_flux(t(np.stack([_starfield(shift=s, theta=th) for s, th in
                                    [((0.8, -0.5), 0.0), ((1.6, 2.2), 0.004),
                                     ((-2.0, 0.3), -0.003)]])))
    masks = np.ones(imgs.shape, bool)
    masks[1, 10:20, :] = False
    pb, cb = ecc_align_batch(ref, imgs, mode=mode, mask=t(masks))
    for k in range(3):
        ps, cs = ecc_align(ref, imgs[k], mode=mode, mask=t(masks[k]))
        np.testing.assert_allclose(n(pb[k]), n(ps), rtol=0, atol=1e-5)
        assert float(cb[k]) == pytest.approx(float(cs), abs=1e-5)


def test_warp_matrices_and_modes():
    p = t(np.array([[0.3, -0.2, 0.01]], np.float32))
    m = n(warp_params_to_matrix(p, "euclidian"))[0]
    np.testing.assert_allclose(m, [[np.cos(0.01), -np.sin(0.01), 0.3],
                                   [np.sin(0.01), np.cos(0.01), -0.2]], rtol=1e-6)
    np.testing.assert_array_equal(n(warp_params_to_matrix(p[:, :2], "translation"))[0],
                                  np.float32([[1, 0, 0.3], [0, 1, -0.2]]))
    with pytest.raises(ValueError):
        warp_params_to_matrix(p, "bogus")
    with pytest.raises(ValueError):
        ecc_align_batch(torch.zeros(8, 8), torch.zeros(1, 8, 8), mode="unchanged")


@pytest.fixture(scope="module")
def sim_frames():
    """The six frames of tests/test_prepare.py:172's movement-kernel sim."""
    sim = simulate_sector(SimConfig(shape=(64, 64), n_times=6, n_stars=15, seed=3,
                                    jitter_amp=0.3))
    return sim.images.astype(np.float32)


def test_motion_model_takes_the_jax_signature(sim_frames):
    """MotionModel(warpmode, image_ref, wcs_ref): the second positional
    argument is the reference image in both packages."""
    ref = sim_frames[0]
    jm, tm = JaxMotion("translation", ref), MotionModel("translation", ref)
    assert tm.wcs_ref is None and jm.wcs_ref is None
    np.testing.assert_allclose(tm.calc_kernel(sim_frames[3], device="cpu"),
                               jm.calc_kernel(sim_frames[3]), rtol=0, atol=P_ATOL)
    np.testing.assert_allclose(n(tm.image_ref), np.asarray(jm.image_ref), rtol=0,
                               atol=FLUX_ATOL)


def test_calc_kernels_match_jax(sim_frames, monkeypatch):
    ref = sim_frames[0]
    jm, tm = JaxMotion("translation", image_ref=ref), MotionModel("translation", image_ref=ref)
    batches = []

    def spy(ref_, frames, **kw):
        batches.append(frames.shape[0])
        return ecc_align_batch(ref_, frames, **kw)

    monkeypatch.setattr(motion_mod, "ecc_align_batch", spy)
    want = jm.calc_kernels_batch(sim_frames)
    got = tm.calc_kernels_batch(sim_frames, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (6, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)
    assert batches == [6]
    for k in (0, 4):
        single = tm.calc_kernel(sim_frames[k], device="cpu")
        assert single.dtype == np.float64
        np.testing.assert_allclose(single, jm.calc_kernel(sim_frames[k]), rtol=0, atol=P_ATOL)
    # Sub-batches bounded by bytes: 4 frames' worth, so 4 + 2, same result.
    frame = motion_mod.ecc_frame_bytes(64, 64, "translation")
    monkeypatch.setattr(motion_mod, "ECC_BUDGET_BYTES", 4.5 * frame)
    assert motion_mod.ecc_sub_batch(64, 64, "translation") == 4
    batches.clear()
    np.testing.assert_allclose(tm.calc_kernels_batch(t(sim_frames), device="cpu"), got,
                               rtol=0, atol=1e-5)
    assert batches == [4, 2]
    monkeypatch.setattr(motion_mod, "ECC_BUDGET_BYTES", 0.5 * frame)
    assert motion_mod.ecc_sub_batch(64, 64, "translation") == 1


def test_estimation_defaults_to_the_card(sim_frames, monkeypatch):
    """Called as the JAX package is called, with arrays and no device, the
    estimation runs on the card: without one it raises and computes
    nothing on the CPU.  The registration ops take tensors only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **kw):
        raise AssertionError("registration ran without a device asked for")

    monkeypatch.setattr(motion_mod, "prepare_flux", refuse)
    mm = MotionModel("translation", sim_frames[0])
    assert mm.image_ref is None                    # construction computes nothing
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mm.calc_kernel(sim_frames[3])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mm.calc_kernels_batch(sim_frames)
    for call in (lambda: prepare_flux(sim_frames[0]),
                 lambda: ecc_align(t(sim_frames[0]), sim_frames[1], mode="translation"),
                 lambda: ecc_align_batch(t(sim_frames[0]), sim_frames[1:], mode="translation")):
        with pytest.raises(TypeError, match="torch.Tensor"):
            call()


def test_calc_kernel_modes_without_reference(sim_frames):
    for cls in (JaxMotion, MotionModel):
        um = cls("unchanged")
        assert um.calc_kernel(sim_frames[0]).shape == (0,)
        assert um.n_params == 0
        tm = cls("euclidian")
        with pytest.raises(RuntimeError, match="Reference image not defined"):
            tm.calc_kernel(sim_frames[0])
    assert MotionModel("unchanged").calc_kernel(sim_frames[0], device="cpu").shape == (0,)
    assert MotionModel("unchanged").calc_kernels_batch(sim_frames, device="cpu").shape == (6, 0)
    with pytest.raises(RuntimeError, match="Reference image not defined"):
        MotionModel("affine").calc_kernels_batch(sim_frames, device="cpu")
