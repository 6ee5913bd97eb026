"""The PSF fit kernel's share of its roofline over the traced window: the
time its recorded launches take at the card's peaks (``perfbench.psf_work``:
each launch the larger of its operations' time, the normal equations at
the TF32 peak over 3 and the rest at the float32 peak, and its bytes' time
at the HBM bandwidth), as a share of the device time of the activities
named ``psf_warm_fit``."""

from perfbench import psf_work


def read(run):
    tr, shapes = run.get("trace"), run.get("psf_launches")
    if not tr or not shapes:
        return None
    kernel_s = sum(v for k, v in tr["kernels_s"].items() if "psf_warm_fit" in k)
    if kernel_s <= 0:
        return None
    launches = []
    for key, n in shapes.items():
        launches += [tuple(int(x) for x in key.split(","))] * n
    return 100.0 * psf_work.bound_s(launches) / kernel_s
