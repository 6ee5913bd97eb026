"""Percent of the PSF fit instances (one target at one cadence, as handed to
the fitter: the ``psf_instances`` counter of ``models.psf_fit``) that the
fused route fitted, the CUDA kernel ``psf_warm_fit.cu``
(``psf_fused_instances``).  None where the program has no such counters."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("psf_instances") or "psf_fused_instances" not in t:
        return None
    return 100 * t["psf_fused_instances"] / t["psf_instances"]
