"""
Version handling for photometry_tpu_torch.

The port's copy of ``photometry_tpu/version.py`` (reference
photometry/version.py:68-154, simplified): a static version with a
git-describe refinement when running from a checkout.
"""

import os
import subprocess

__version__ = "0.1.0"


def get_version(pep440: bool = False) -> str:
    """Return the package version, refined with git-describe when available.

    Parameters:
        pep440: If True, return a PEP440-compliant local version string.
    """
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(
            ["git", "describe", "--tags", "--always", "--dirty"],
            cwd=root, capture_output=True, text=True, timeout=10, check=False)
        desc = out.stdout.strip()
        if out.returncode != 0 or not desc:
            return __version__
    except (OSError, subprocess.SubprocessError):
        return __version__
    if pep440:
        return __version__ + "+" + desc.replace("-", ".")
    return f"{__version__} ({desc})"
