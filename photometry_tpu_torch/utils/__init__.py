"""Numeric helpers of the port."""
