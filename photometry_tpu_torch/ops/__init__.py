"""Array operations of the port: labeling, filters, registration, extraction and the CUDA
kernels."""
