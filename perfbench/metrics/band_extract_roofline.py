"""The band kernel's share of its roofline over the traced window: the bytes
its recorded launches need, each input byte read once
(``drivers.drain.band_bytes``), over the card's HBM bandwidth, as a share
of the device time of the activities named ``band_extract``.  The band
sums do a few additions a byte, so bytes bound them."""

from perfbench.trace import roofline_pct


def read(run):
    return roofline_pct(run, "band_bytes", "band_extract")
