"""The 15x15 median kernel's share of its roofline over the traced window:
the bytes its recorded launches need (each (F, H, W) float32 input read
once, the medians written once: 268.4 MB per 8 2048x2048 frames) over the
card's HBM bandwidth, as a share of the device time of the activities
named ``median15``.  A median is a selection with no multiply-adds to
count, so bytes bound it."""

from perfbench.trace import roofline_pct


def read(run):
    return roofline_pct(run, "median_bytes", "median15")
