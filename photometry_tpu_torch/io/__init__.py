"""File formats and coordinate systems of the port (WCS, cube reader)."""
