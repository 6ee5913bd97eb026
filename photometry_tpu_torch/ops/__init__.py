"""Array operations of the port: labeling, filters, banded extraction and its CUDA kernel."""
