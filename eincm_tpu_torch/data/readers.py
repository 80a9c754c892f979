"""Thin file readers with the context-manager protocol.

Carried over from eincm_tpu/data/readers.py (reference:
src/dataloaders/reader_utils/hdf5_file_reader.py:4-53,
numpy_file_reader.py:4-45, mvsec_utils/mvsec_reader.py:7-75), for a
machine that may lack h5py and imageio:
- `HDF5FileReader` opens a file with h5py where h5py imports (then, as in
  the JAX package, a file with Blosc or other plugin chunks needs
  hdf5plugin too), and with the port's `utils/h5_lite.py` otherwise; its
  `backend` attribute names the one it used;
- `imread_gray` decodes PNGs with `utils/png16.py:read_png`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from eincm_tpu_torch.utils import h5_lite
from eincm_tpu_torch.utils.png16 import read_png


class HDF5FileReader:
    """Datasets are materialized into numpy on read."""

    def __init__(self, path):
        self.path = Path(path)
        self.h5_file = None
        self.backend = None  # "h5py" or "h5_lite", once open

    def open_file(self):
        try:
            import h5py  # optional dependency, imported lazily
        except ImportError:
            self.h5_file = h5_lite.File(self.path)
            self.backend = "h5_lite"
            return self
        try:
            import hdf5plugin  # noqa: F401  (compression codecs, if present)
        except ImportError:
            pass
        self.h5_file = h5py.File(self.path, "r")
        self.backend = "h5py"
        return self

    def close_file(self):
        if self.h5_file is not None:
            self.h5_file.close()
            self.h5_file = None

    def read_dataset(self, key: str) -> np.ndarray:
        assert self.h5_file is not None, "open the file first"
        if self.backend == "h5_lite":
            return self.h5_file.read(key)
        return np.asarray(self.h5_file[key])

    def read_attr(self, key: str) -> Any:
        assert self.h5_file is not None, "open the file first"
        if self.backend == "h5_lite":
            return self.h5_file.read(key)[()]
        return self.h5_file[key][()]

    def __enter__(self):
        return self.open_file()

    def __exit__(self, *exc):
        self.close_file()


class NumpyFileReader:
    """np.load-backed reader for .npz/.npy files."""

    def __init__(self, path):
        self.path = Path(path)
        self.np_file = None

    def open_file(self):
        self.np_file = np.load(self.path, allow_pickle=True)
        return self

    def close_file(self):
        if self.np_file is not None and hasattr(self.np_file, "close"):
            self.np_file.close()
        self.np_file = None

    def read_array(self, key: str) -> np.ndarray:
        assert self.np_file is not None, "open the file first"
        if isinstance(self.np_file, np.ndarray):
            # a bare .npy holds exactly one unnamed array — the key only
            # selects members of an .npz archive
            return np.asarray(self.np_file)
        return np.asarray(self.np_file[key])

    def __enter__(self):
        return self.open_file()

    def __exit__(self, *exc):
        self.close_file()


class MVSECReader:
    """Dispatches to HDF5 or numpy readers on file extension
    (reference: mvsec_reader.py:7-75)."""

    def __init__(self, path):
        self.file_path = Path(path)
        ext = self.file_path.suffix.lower()
        if ext in (".hdf5", ".h5"):
            self._rdr = HDF5FileReader(self.file_path)
        elif ext in (".npz", ".npy"):
            self._rdr = NumpyFileReader(self.file_path)
        else:
            raise ValueError(f"unsupported MVSEC file type: {ext}")

    def open_file(self):
        self._rdr.open_file()
        return self

    def close_file(self):
        self._rdr.close_file()

    def read_h5_dataset(self, key):
        return self._rdr.read_dataset(key)

    def read_np_array(self, key):
        return self._rdr.read_array(key)

    def __enter__(self):
        return self.open_file()

    def __exit__(self, *exc):
        self.close_file()


def imread_gray(path) -> np.ndarray:
    """Load a PNG as eincm_tpu/data/readers.py:imread_gray loads it: the
    image as imageio gives it (`utils/png16.py:read_png`: bool, uint8 or
    uint16 greyscale as it is), colour by the BT.601 luminance of its
    first three channels (as cv.IMREAD_GRAYSCALE), cast to uint8. An 8-bit
    grey + alpha PNG raises, as the JAX function does (IndexError there).
    Shared by the DSEC and ECD loaders."""
    img = read_png(path)
    if img.ndim == 3 and img.shape[2] < 3:
        raise ValueError(f"{path}: a grey + alpha PNG has no third channel for the "
                         "BT.601 luminance")
    if img.ndim == 3:
        img = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        ).astype(np.uint8)
    return img
