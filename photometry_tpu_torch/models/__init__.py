"""Photometry models of the port (K2P2 masks)."""
