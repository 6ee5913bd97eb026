"""Shared helpers of the JAX-vs-torch parity tests (tests/test_torch_*.py).

The tier-1 run uses several xdist workers on one host, so each worker's
torch keeps to one intra-op thread.
"""

import numpy as np
import torch

torch.set_num_threads(1)

#: Float tolerance of the extraction outputs (tests/test_bandext.py:41):
#: float32 sums taken in another order.
RTOL, ATOL = 1e-4, 1e-3


def t(x, dtype=None):
    """numpy -> CPU tensor (copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """tensor / jax array / numpy -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_extraction_parity(got, want):
    """The five extraction outputs: booleans equal, floats to RTOL/ATOL."""
    for name, a, b in zip(["flux", "ferr", "fbkg", "cent", "shen"], got, want):
        a, b = n(a), n(b)
        assert a.shape == b.shape, name
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=name)
