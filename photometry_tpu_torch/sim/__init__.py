"""Synthetic TESS data (the port's copy of ``photometry_tpu.sim``)."""
