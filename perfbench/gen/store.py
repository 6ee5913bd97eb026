"""An in-memory cube store for ``prepare.prepare_cube`` (the card's machine
has no h5py to write a cube file).

Frozen copy of the smoke run's ``DictCube``, cut to the ``io.cube.ImageCube``
methods that stages 1-5 of the prepare stage call, on host arrays; reads return copies, as
h5py does.  It also keeps what the stage writes and then drops, for the
reference to judge: the raw backgrounds of a sample of pixels (from the
first write of each block, before the time smoothing overwrites it) and
the median-filtered residuals of the scratch stack.
"""

import numpy as np


class Store:
    def __init__(self, n_times, shape, header=None, sample=None):
        self.n_times, self.shape = n_times, tuple(shape)
        self.attrs = {k: v for k, v in (header or {}).items() if v is not None}
        self.stages, self.vectors = set(), {}
        full = (n_times,) + self.shape
        self.arrays = {k: np.zeros(full, np.float32) for k in ("images", "images_err",
                                                               "backgrounds")}
        self.arrays["pixelflags"] = np.zeros(full, np.uint8)
        # ``sample``: flat pixel indices whose raw backgrounds are kept
        self.sample = np.zeros(0, np.int64) if sample is None else np.asarray(sample, np.int64)
        self.raw_sample = np.zeros((n_times, len(self.sample)), np.float32)
        self._raw_done = set()
        self.wcs = [""] * n_times
        self.scratch = self.residuals = None
        self._sumimage = self.pixels_used = None

    def is_done(self, stage):
        return stage in self.stages

    def mark_done(self, stage):
        self.stages.add(stage)

    def write_block(self, name, t0, block):
        if name == "backgrounds" and t0 not in self._raw_done:
            self._raw_done.add(t0)
            self.raw_sample[t0:t0 + block.shape[0]] = block.reshape(block.shape[0], -1)[
                :, self.sample]
        self.arrays[name][t0:t0 + block.shape[0]] = block

    def write_frame(self, k, wcs_str=None):
        if wcs_str is not None:
            self.wcs[k] = wcs_str

    def images(self, t0=0, t1=None):
        return self.arrays["images"][t0:t1].copy()

    def backgrounds(self, t0=0, t1=None):
        return self.arrays["backgrounds"][t0:t1].copy()

    def pixelflags(self, t0=0, t1=None):
        return self.arrays["pixelflags"][t0:t1].copy()

    def write_vectors(self, **kw):
        self.vectors.update({k: np.array(v) for k, v in kw.items() if v is not None})

    time = property(lambda self: self.vectors["time"].copy())
    timecorr = property(lambda self: self.vectors["timecorr"].copy())
    quality = property(lambda self: self.vectors["quality"].copy())
    sumimage = property(lambda self: self._sumimage.copy())

    def write_time_bounds(self, time_start, time_stop):
        self.vectors.update(time_start=np.array(time_start, np.float64),
                            time_stop=np.array(time_stop, np.float64))

    def time_bounds(self):
        return self.vectors["time_start"].copy(), self.vectors["time_stop"].copy()

    def write_sumimage(self, sumimage, pixels_used=None):
        self._sumimage = np.array(sumimage, np.float64)
        if pixels_used is not None:
            self.pixels_used = np.array(pixels_used, np.uint8)

    def wcs_strings(self):
        return list(self.wcs)

    def create_scratch(self):
        self.scratch = np.zeros((self.n_times,) + self.shape, np.float32)

    def write_scratch(self, t0, block):
        self.scratch[t0:t0 + block.shape[0]] = block

    def read_scratch(self, index):
        return self.scratch[index].copy()

    def delete_scratch(self):
        self.residuals, self.scratch = self.scratch, None
