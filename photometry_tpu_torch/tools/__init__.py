"""Tools that drive the port (the counterparts of the repository's ``tools/``)."""
