"""
Diagnostic movies of prepared image cubes.

Port of ``photometry_tpu/movie.py`` (reference run_ffimovie.py): per-CCD
movies of the background-subtracted images, backgrounds or pixel flags
with colour scales computed once and cached as attributes of the cube
(run_ffimovie.py:98-132), and the 16-CCD focal-plane mosaic with each
CCD's rotation (:240-243).  Frames render with matplotlib and are written
as an animated GIF (Pillow), a PNG sequence, or an MP4 where an ``ffmpeg``
binary is on PATH.

The cubes are read through ``io.cube.ImageCube``, which needs ``h5py``: the
movies are host work, on the CPU, wherever the cube files can be opened.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from .io.cube import ImageCube
from .plots import plot_image, plt, set_copyright

logger = logging.getLogger(__name__)

__all__ = ["make_movie", "make_combined_movie", "mosaic_frame"]


def _color_scale(cube: ImageCube, dataset: str = "images") -> tuple:
    """Percentile colour scale, cached as attrs on the cube (ffimovie:98-132)."""
    key_lo, key_hi = f"_movie_vmin_{dataset}", f"_movie_vmax_{dataset}"
    if key_lo in cube.attrs and key_hi in cube.attrs:
        return float(cube.attrs[key_lo]), float(cube.attrs[key_hi])
    n = cube.n_times
    idx = np.unique(np.linspace(0, n - 1, min(8, n)).astype(int))
    samples = np.concatenate([getattr(cube, dataset)(k, k + 1).ravel() for k in idx])
    samples = samples[np.isfinite(samples)]
    if samples.size == 0:
        vmin, vmax = 0.0, 1.0
    else:
        vmin, vmax = np.percentile(samples, [1.0, 99.0])
    try:
        cube.attrs[key_lo] = vmin
        cube.attrs[key_hi] = vmax
    except (OSError, KeyError, ValueError):
        pass  # read-only file
    return float(vmin), float(vmax)


def ffmpeg_available() -> bool:
    """True when an ``ffmpeg`` binary is on PATH (capability check for the
    MP4 output the reference writes, run_ffimovie.py:66-211)."""
    import shutil
    return shutil.which("ffmpeg") is not None


def _write_mp4(frames, out: str, fps: int) -> str:
    """Encode a list of PIL RGB frames to H.264 MP4 by piping raw video to
    ffmpeg (no third-party encoder dependency; yuv420p for compatibility,
    matching the reference's ffmpeg settings at run_ffimovie.py:198-205)."""
    import subprocess
    w, h = frames[0].size
    # H.264 requires even dimensions:
    w -= w % 2
    h -= h % 2
    proc = subprocess.Popen(
        ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
         "-an", "-vcodec", "libx264", "-pix_fmt", "yuv420p", out],
        stdin=subprocess.PIPE)
    try:
        for f in frames:
            proc.stdin.write(np.asarray(f)[:h, :w].tobytes())
        proc.stdin.close()
    except BrokenPipeError:
        # encoder exited early (missing libx264, bad output path, ...):
        # fall through to the exit-status check for a clear error instead
        # of an opaque pipe traceback.
        pass
    if proc.wait() != 0:
        raise RuntimeError(f"ffmpeg failed encoding {out}")
    return out


def make_movie(cube_path: str, output: Optional[str] = None,
               dataset: str = "images", fps: int = 10,
               max_frames: Optional[int] = None, fmt: str = "gif",
               dpi: int = 80) -> str:
    """Render one cube dataset to an MP4 (when ffmpeg is available), an
    animated GIF, or a PNG frame directory (``fmt`` in mp4/gif/png)."""
    if fmt == "mp4" and not ffmpeg_available():
        raise RuntimeError("fmt='mp4' requires an ffmpeg binary on PATH "
                           "(use fmt='gif' on hosts without one)")
    from PIL import Image as PILImage
    mode = "r+"
    try:
        cube = ImageCube(cube_path, mode)
    except OSError:
        cube = ImageCube(cube_path, "r")
    try:
        vmin, vmax = _color_scale(cube, dataset)
        T = cube.n_times if max_frames is None else min(cube.n_times, max_frames)
        if T <= 0:
            raise ValueError(f"No frames to render from {cube_path} "
                             f"(T={cube.n_times}, max_frames={max_frames})")
        hdr = cube.header
        frames = []
        outdir = None
        if fmt == "png":
            outdir = output or cube_path.replace(".hdf5", f"_{dataset}_frames")
            os.makedirs(outdir, exist_ok=True)
        for k in range(T):
            img = getattr(cube, dataset)(k, k + 1)[0]
            fig = plt.figure(figsize=(6, 6), dpi=dpi)
            ax = fig.add_subplot(111)
            plot_image(img, ax=ax, scale="sqrt", vmin=vmin, vmax=vmax,
                       title=f"S{hdr.get('SECTOR', 0):02d} cam{hdr.get('CAMERA', 0)} "
                             f"ccd{hdr.get('CCD', 0)} {dataset} #{k}",
                       cbar="right")
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
            plt.close(fig)
            if fmt == "png":
                PILImage.fromarray(buf).save(os.path.join(outdir, f"{k:04d}.png"))
            else:
                frames.append(PILImage.fromarray(buf))
        if fmt == "png":
            return outdir
        out = output or cube_path.replace(".hdf5", f"_{dataset}.{fmt}")
        if fmt == "mp4":
            _write_mp4(frames, out, fps)
        else:
            frames[0].save(out, save_all=True, append_images=frames[1:],
                           duration=int(1000 / fps), loop=0)
        logger.info("Movie written: %s", out)
        return out
    finally:
        cube.close()


#: Focal-plane rotations (quarter turns) of each (camera, ccd) in the mosaic,
#: matching the layout of reference run_ffimovie.py:240-243.
_MOSAIC_ROT = {1: 2, 2: 2, 3: 0, 4: 0}


def mosaic_frame(input_folder: str, sector: int, k: int = 0,
                 dataset: str = "images") -> np.ndarray:
    """Assemble one 16-CCD (4 cameras x 4 CCDs) mosaic frame.

    Missing CCDs render as NaN blocks.  Returns the mosaic image.
    """
    cubes = _open_mosaic_cubes(input_folder, sector)
    try:
        return _mosaic_from_cubes(cubes, k, dataset)
    finally:
        for cube in cubes.values():
            cube.close()


def _open_mosaic_cubes(input_folder: str, sector: int) -> dict:
    """{(camera, ccd): open ImageCube} for every available CCD of a sector.

    Resolved ONCE per movie: re-globbing and re-opening all 16 HDF5 files
    per cadence cost ~20,000 open/lock/close cycles for one full-sector
    combined movie.
    """
    from .io import discovery
    cubes = {}
    for camera in (1, 2, 3, 4):
        for ccd in (1, 2, 3, 4):
            files = discovery.find_cube_files(input_folder, sector=sector,
                                              camera=camera, ccd=ccd)
            if files:
                cubes[(camera, ccd)] = ImageCube(files[0])
    if not cubes:
        raise FileNotFoundError(f"No cubes for sector {sector} in {input_folder}")
    return cubes


def _mosaic_from_cubes(cubes: dict, k: int, dataset: str) -> np.ndarray:
    tile = None
    blocks = {}
    for (camera, ccd), cube in cubes.items():
        img = getattr(cube, dataset)(k, k + 1)[0]
        img = np.rot90(img, _MOSAIC_ROT[ccd])
        blocks[(camera, ccd)] = img
        tile = img.shape
    H, W = tile
    mosaic = np.full((4 * H, 4 * W), np.nan, np.float32)
    for (camera, ccd), img in blocks.items():
        row = (camera - 1)
        col = (ccd - 1)
        mosaic[row * H:(row + 1) * H, col * W:(col + 1) * W] = img
    return mosaic


def make_combined_movie(input_folder: str, sector: int,
                        output: Optional[str] = None,
                        dataset: str = "images", fps: int = 10,
                        max_frames: Optional[int] = None, fmt: str = "gif",
                        dpi: int = 80) -> str:
    """Movie of the full 16-CCD focal-plane mosaic for one sector.

    Counterpart of reference ``run_ffimovie.make_combined_movie``
    (run_ffimovie.py:214-378): every available camera/CCD cube of the
    sector renders into one rotated mosaic per cadence.  Missing CCDs show
    as blank blocks; the colour scale is shared across the whole mosaic
    (1-99 percentiles of a frame sample).
    """
    if fmt == "mp4" and not ffmpeg_available():
        raise RuntimeError("fmt='mp4' requires an ffmpeg binary on PATH "
                           "(use fmt='gif' on hosts without one)")
    cubes = _open_mosaic_cubes(input_folder, sector)
    try:
        return _make_combined_movie(cubes, input_folder, sector, output,
                                    dataset, fps, max_frames, fmt, dpi)
    finally:
        for cube in cubes.values():
            cube.close()


def _make_combined_movie(cubes, input_folder, sector, output, dataset, fps,
                         max_frames, fmt, dpi):
    from PIL import Image as PILImage
    T = next(iter(cubes.values())).n_times
    if max_frames is not None:
        T = min(T, max_frames)
    if T <= 0:
        raise ValueError(
            f"Cube for sector {sector} has no cadences (T={T}); nothing to render")

    # Shared colour scale from a sample of mosaics:
    idx = np.unique(np.linspace(0, T - 1, min(4, T)).astype(int))
    samples = np.concatenate([_mosaic_from_cubes(cubes, int(k),
                                                 dataset).ravel() for k in idx])
    samples = samples[np.isfinite(samples)]
    vmin, vmax = (np.percentile(samples, [1.0, 99.0]) if samples.size
                  else (0.0, 1.0))

    outdir = None
    if fmt == "png":
        outdir = output or os.path.join(
            input_folder, f"sector{sector:03d}_combined_{dataset}_frames")
        os.makedirs(outdir, exist_ok=True)
    frames = []
    for k in range(T):
        mosaic = _mosaic_from_cubes(cubes, k, dataset)
        fig = plt.figure(figsize=(8, 8), dpi=dpi)
        ax = fig.add_subplot(111)
        plot_image(mosaic, ax=ax, scale="sqrt", vmin=float(vmin),
                   vmax=float(vmax),
                   title=f"S{sector:02d} combined {dataset} #{k}")
        set_copyright(fig)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        if fmt == "png":
            PILImage.fromarray(buf).save(os.path.join(outdir, f"{k:05d}.png"))
        else:
            frames.append(PILImage.fromarray(buf))
    if fmt == "png":
        return outdir
    out = output or os.path.join(
        input_folder, f"sector{sector:03d}_combined_{dataset}.{fmt}")
    if fmt == "mp4":
        _write_mp4(frames, out, fps)
    else:
        frames[0].save(out, save_all=True, append_images=frames[1:],
                       duration=max(1, int(1000 / fps)), loop=0)
    return out
