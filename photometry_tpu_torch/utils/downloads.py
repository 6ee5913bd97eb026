"""
Resilient file downloads (retry + atomic move + optional parallelism).

The port's own copy of ``photometry_tpu/utils/downloads.py`` (reference
photometry/utilities.py:297-421: ``download_file`` with urllib3 retries and
``download_parallel`` over a thread pool), on the standard library only.
Every fetch is optional and configured by a URL (``file://`` reads a local
file); ``catalog.download_catalogs`` calls these helpers.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import time
import urllib.request

logger = logging.getLogger(__name__)

__all__ = ["download_file", "download_parallel"]


def download_file(url: str, destination: str, timeout: float = 60,
                  retries: int = 3, backoff: float = 2.0) -> str:
    """Download ``url`` to ``destination`` with retries and an atomic move."""
    os.makedirs(os.path.dirname(os.path.abspath(destination)), exist_ok=True)
    tmp = destination + ".part"
    last_err = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp, \
                    open(tmp, "wb") as out:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
            os.replace(tmp, destination)
            return destination
        except OSError as err:
            last_err = err
            logger.warning("Download failed (%d/%d): %s", attempt + 1, retries, err)
            time.sleep(backoff ** attempt)
    if os.path.exists(tmp):
        os.remove(tmp)
    raise OSError(f"Could not download {url}") from last_err


def download_parallel(jobs, workers: int = 4) -> list:
    """Download [(url, destination), ...] concurrently; returns destinations."""
    results = [None] * len(jobs)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {pool.submit(download_file, url, dest): i
                for i, (url, dest) in enumerate(jobs)}
        for fut in concurrent.futures.as_completed(futs):
            results[futs[fut]] = fut.result()
    return results
