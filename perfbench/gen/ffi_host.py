"""The FFI cube of ``gen.ffi`` kept in host memory.

Each block of 64 frames is drawn on the card exactly as ``ffi.cube`` draws
it (the same generator, the same order of draws, the same cast) and copied
at once into pageable host planes, so the card never holds the cube: a
float32 host cube and ``ffi.cube``'s device cube of one seed hold the same
bits.  ``sector`` is ``ffi.sector`` on that cube.
"""

from unittest import mock

import torch

from . import ffi
from . import field as fld


def cube(cfg, mix, seed, device, dtype=torch.float32, host=None):
    """``ffi.cube``'s (images, errors, backgrounds, flags), sum image and
    phases, the four planes pageable CPU tensors in ``dtype`` (flags uint8)."""
    rows, cols, tmag, img0, lay = host or ffi.layout(cfg, mix)
    H, W, T = cfg["rows"], cfg["cols"], cfg["n_times"]
    noise = cfg["noise"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    inj = fld.Injector(lay, mix, T, H, W, cfg["field"]["psf_sigma_px"], noise["saturation"],
                       noise["exptime_s"], gen, device)
    base = torch.as_tensor(img0, device=device)
    sigma = torch.sqrt((torch.clamp(base, min=0.0) + noise["sky"]) / noise["exptime_s"])
    planes = [torch.empty(T, H, W, dtype=dtype) for _ in range(3)]
    flags = torch.empty(T, H, W, dtype=torch.uint8)
    total = torch.zeros(H, W, device=device, dtype=torch.float64)
    n_nan = noise["nan_pixels"]
    for t0 in range(0, T, ffi.BLOCK):
        n = min(ffi.BLOCK, T - t0)
        img = base + sigma * torch.randn(n, H, W, device=device, generator=gen)
        err = sigma.expand(n, H, W).clone()
        bkg = 20.0 + torch.randn(n, H, W, device=device, generator=gen)
        flg = (torch.rand(n, H, W, device=device, generator=gen) < 1e-4).to(torch.uint8) * 4
        k = n_nan * (t0 + n) // T - n_nan * t0 // T
        idx = torch.randint(0, n * H * W, (k,), device=device, generator=gen)
        bkg.view(-1)[idx] = float("nan")
        inj.add(img, err, t0)
        total += img.sum(dim=0, dtype=torch.float64)
        for p, x in zip(planes, (img, err, bkg)):
            p[t0:t0 + n].copy_(x.to(dtype))          # cast where ffi.cube casts: on the card
        flags[t0:t0 + n].copy_(flg)
        del img, err, bkg, flg
    return planes + [flags], (total / T).float().cpu().numpy(), inj.phases.cpu().numpy()


def sector(cfg, mix, seed, device, work, dtype=torch.float32):
    """``ffi.sector`` with the cube in host memory (``ctx_kw``'s planes are
    this module's)."""
    with mock.patch.object(ffi, "cube", cube):
        return ffi.sector(cfg, mix, seed, device, work, dtype)
