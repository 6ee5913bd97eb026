"""The seeded star field of one CCD and the stars a drain mix adds to it.

Frozen copies of the field and phase-7 builders of the repository's smoke
run (``make_field``, ``phase7_layout``, ``psf_window``, ``inject_phase7``),
with every size taken from the configuration and the traffic file.  The
injection works on one block of frames at a time, so that a cube is made
block by block on the card in any dtype from the same draws.
"""

import numpy as np

ZERO_POINT = 20.451              # Tmag of 1 e-/s (the port's mag2flux)
AMPLITUDE, PERIODS = 0.01, 2      # the bright stars' sinusoid over the T frames


def mag2flux(tmag):
    return 10 ** (-0.4 * (np.asarray(tmag, np.float64) - ZERO_POINT))


def variation(t, T, phase):
    """A bright star's flux at frames ``t`` as a share of its mean."""
    return 1.0 + AMPLITUDE * np.sin(2 * PERIODS * np.pi * np.asarray(t, np.float64) / T + phase)


def make_field(rng, field, H, W, image=True):
    """rows, cols, tmag (sorted) and, with ``image``, the (H, W) sum image:
    ``n_stars`` Gaussian stars of sigma ``psf_sigma_px`` sampled on a 15x15
    window, on Gaussian noise of 1.5."""
    n, sig = field["n_stars"], field["psf_sigma_px"]
    rows = rng.uniform(10, H - 10, n)
    cols = rng.uniform(10, W - 10, n)
    tmag = np.sort(rng.uniform(field["tmag_min"], field["tmag_max"], n))
    if not image:
        return rows, cols, tmag, None
    flux = mag2flux(tmag)
    img0 = rng.normal(0.0, 1.5, (H, W)).astype(np.float32)
    win = 7
    yy, xx = np.mgrid[-win:win + 1, -win:win + 1]
    for r, c, f in zip(rows, cols, flux):
        ri, ci = int(r), int(c)
        g = f * np.exp(-0.5 * ((yy + ri - r) ** 2 + (xx + ci - c) ** 2) / sig ** 2)
        g *= 1.0 / (2 * np.pi * sig ** 2)
        r0, r1 = max(ri - win, 0), min(ri + win + 1, H)
        c0, c1 = max(ci - win, 0), min(ci + win + 1, W)
        img0[r0:r1, c0:c1] += g[(r0 - ri + win):(r1 - ri + win), (c0 - ci + win):(c1 - ci + win)]
    return rows, cols, tmag, img0


def crpix(H, W):
    """The field's TAN reference pixel (1-based column, row)."""
    return np.array([W / 2 + 0.5, H / 2 + 0.5])


def field_wcs(H, W):
    from photometry_tpu_torch.io.wcs import TanWCS
    return TanWCS(crpix=list(crpix(H, W)), crval=[95.0, -60.0],
                  cd=[[-21.0 / 3600, 0.0], [0.0, 21.0 / 3600]])


def layout(rng, rows, cols, mix, H, W):
    """Positions and magnitudes of the mix's injected stars: ``bright``
    stars (Tmag 3.5-6.0) on the two halo routes (half 1-2 px inside the
    left or right CCD edge, half with a ``tail``-row charge tail up a clear
    column corridor) and ``pairs`` blends (3.5-6.0 px, Tmag 10.0 and 10.3)
    clear of field stars.  Raises if the field leaves no room."""
    n_bright, n_pairs, tail = mix["bright"], mix["pairs"], mix["tail"]
    n_edge = n_bright // 2
    span = np.linspace(60, H - 60, n_edge)
    b_rows = list(span + rng.uniform(-5, 5, n_edge))
    b_cols = list(np.where(np.arange(n_edge) % 2 == 0, rng.uniform(1.0, 2.0, n_edge),
                           W - 1 - rng.uniform(1.0, 2.0, n_edge)))
    for _ in range(200000):
        if len(b_rows) == n_bright:
            break
        r, c = rng.uniform(40, H - tail - 40), rng.uniform(60, W - 60)
        in_corridor = (np.abs(cols - c) <= 4) & (rows > r - 10) & (rows < r + tail + 10)
        if in_corridor.any() or any(abs(c - c2) < 30 and abs(r - r2) < tail + 40
                                    for r2, c2 in zip(b_rows[n_edge:], b_cols[n_edge:])):
            continue
        b_rows.append(r)
        b_cols.append(c)
    if len(b_rows) != n_bright:
        raise RuntimeError(f"room for {len(b_rows) - n_edge} of {n_bright - n_edge} tails")
    b_rows, b_cols = np.array(b_rows), np.array(b_cols)
    b_tmag = np.concatenate([rng.uniform(3.5, 6.0, n_edge),
                             rng.uniform(3.5, 4.5, n_bright - n_edge)])
    route = np.array(["edge"] * n_edge + ["tail"] * (n_bright - n_edge))

    pairs = []
    seps = np.linspace(3.5, 6.0, n_pairs)
    for _ in range(100000):
        if len(pairs) == n_pairs:
            break
        r, c = rng.uniform(30, H - 40), rng.uniform(30, W - 40)
        sep = seps[len(pairs)]
        r2, c2 = r + sep * 0.7, c + sep * 0.714
        if (np.min(np.hypot(rows - r, cols - c)) < 7 or np.min(np.hypot(rows - r2, cols - c2)) < 7
                or np.any((np.abs(b_cols - c) < 40) & (r > b_rows - 40)
                          & (r < b_rows + tail + 40))
                or any(np.hypot(r - p[0], c - p[1]) < 20 for p in pairs)):
            continue
        pairs.append((r, c, r2, c2))
    if len(pairs) != n_pairs:
        raise RuntimeError(f"room for {len(pairs)} of {n_pairs} pairs")
    p = np.array(pairs).reshape(-1, 4)
    return {"b_rows": b_rows, "b_cols": b_cols, "b_tmag": b_tmag, "route": route,
            "p_rows": np.stack([p[:, 0], p[:, 2]], 1).ravel(),
            "p_cols": np.stack([p[:, 1], p[:, 3]], 1).ravel(),
            "p_tmag": np.tile([10.0, 10.3], n_pairs)}


def psf_window(r, c, win, H, W, sig, integrated=False, wing=0.0, reach=7):
    """Rows and columns of a star's window, clipped to the frame, and its
    unit-flux PSF there: a Gaussian core (point-sampled within 7 px, or
    ``integrated`` over each pixel) plus a ``wing`` share in a Moffat halo
    (core radius 2 px, beta 1.5) out to ``reach`` px."""
    from scipy.special import erf
    ri, ci = int(r), int(c)
    r0, r1 = max(ri - max(win, reach), 0), min(ri + max(win, reach) + 1, H)
    c0, c1 = max(ci - reach, 0), min(ci + reach + 1, W)
    yy, xx = np.mgrid[r0:r1, c0:c1]
    if integrated:
        d = np.sqrt(2.0) * sig
        psf = 0.25 * ((erf((yy - r + 0.5) / d) - erf((yy - r - 0.5) / d))
                      * (erf((xx - c + 0.5) / d) - erf((xx - c - 0.5) / d)))
    else:
        psf = np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / sig ** 2) / (2 * np.pi * sig ** 2)
    psf[(np.abs(yy - ri) > 7) | (np.abs(xx - ci) > 7)] = 0.0
    if wing:
        d2 = (yy - r) ** 2 + (xx - c) ** 2
        moffat = 0.5 / (np.pi * 4.0) * (1 + d2 / 4.0) ** -1.5
        psf = (1 - wing) * psf + wing * np.where(d2 <= reach ** 2, moffat, 0.0)
    return r0, r1, c0, c1, psf


class Injector:
    """The mix's stars, added to one block of frames at a time.

    Bright stars vary by a 1% sinusoid (two periods over T, a random phase
    each), hold 5% of their flux in wings out to 40 px, are clipped at
    ``saturation`` with the clipped charge of each column bled along it
    (flux conserved; "tail" stars put 30% of it evenly over ``tail`` rows
    above the star).  Pairs are constant with the pixel-integrated PSF.
    Every injected pixel gets photon noise and its error grows to match."""

    def __init__(self, lay, mix, T, H, W, sig, saturation, exptime, gen, device):
        import torch
        self.T, self.tail, self.S, self.exptime = T, mix["tail"], float(saturation), exptime
        self.gen, self.device = gen, device
        nb = len(lay["b_tmag"])
        self.phases = torch.rand(nb, generator=gen, device=device) * 2 * np.pi
        stars = [(lay["b_rows"][i], lay["b_cols"][i], lay["b_tmag"][i], i, lay["route"][i])
                 for i in range(nb)]
        stars += [(r, c, m, None, "pair") for r, c, m in zip(lay["p_rows"], lay["p_cols"],
                                                               lay["p_tmag"])]
        self.stars = []
        for r, c, m, i, route in stars:
            win = 7 if route == "pair" else 40 if route == "edge" else self.tail + 10
            r0, r1, c0, c1, psf = psf_window(r, c, win, H, W, sig, integrated=route == "pair",
                                             wing=0.0 if route == "pair" else 0.05,
                                             reach=7 if route == "pair" else 40)
            psf_d = torch.as_tensor(float(mag2flux(m)) * psf, dtype=torch.float32, device=device)
            self.stars.append((r, r0, r1, c0, c1, psf_d, i, route))

    def add(self, images, errs, t0):
        """Add the stars to frames t0 .. t0 + n of (n, H, W) blocks, in place."""
        import torch
        n = images.shape[0]
        dev, S, tail = self.device, self.S, self.tail
        tt = torch.arange(t0, t0 + n, device=dev, dtype=torch.float32)
        for r, r0, r1, c0, c1, psf_d, i, route in self.stars:
            star = psf_d[None].expand(n, -1, -1)
            if i is not None:
                mod = 1.0 + AMPLITUDE * torch.sin(2 * PERIODS * np.pi * tt / self.T
                                                  + self.phases[i])
                star = star * mod[:, None, None]
            if route != "pair":
                core = torch.clamp(star, max=S)
                excess = (star - core).sum(dim=1)                          # (n, w)
                if route == "tail":
                    tail_e, excess = 0.3 * excess, 0.7 * excess
                # Fill outward from the star's row, alternating down and up:
                k = torch.arange(r1 - r0, device=dev) + r0 - int(r)
                order = torch.argsort(torch.abs(k) * 2 + (k < 0), stable=True)
                cap = (S - core)[:, order]
                before = torch.cumsum(cap, dim=1) - cap
                fill = torch.minimum(torch.clamp(excess[:, None, :] - before, min=0.0), cap)
                core[:, order] += fill
                if route == "tail":
                    wgt = ((core < 0.5 * S) & ((k > 0) & (k <= tail))[None, :, None]).float()
                    core += tail_e[:, None, :] * wgt / torch.clamp(wgt.sum(dim=1, keepdim=True),
                                                                  min=1.0)
                star = core
            pos = torch.clamp(star, min=0.0) / self.exptime
            noise = torch.sqrt(pos) * torch.randn(star.shape, device=dev, generator=self.gen)
            images[:, r0:r1, c0:c1] += star + noise
            errs[:, r0:r1, c0:c1] = torch.sqrt(errs[:, r0:r1, c0:c1] ** 2 + pos)
