"""ECD (Event Camera Dataset) loader.

Carried over from eincm_tpu/data/ecd.py (reference:
src/dataloaders/ecd_loader.py:22-139): text-file event parsing, the y-2
crop to 176x240, image-timestamp windows, and the shared des_n_events
policy. Frames are decoded by `utils/png16.py` (data/readers.py:imread_gray).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from eincm_tpu_torch.data.readers import imread_gray
from eincm_tpu_torch.data.windowing import adjust_event_window

ECD_HEIGHT = 176
ECD_WIDTH = 240


class ECDDataLoader:
    def __init__(
        self,
        root_dir,
        sequence_name,
        des_n_events: int = 50_000,
        delta_idx: int = 1,
        prefer_latest_events: bool = True,
    ):
        self.root_dir = Path(root_dir)
        self.sequence_name = sequence_name
        self.des_n_events = des_n_events
        self.delta_idx = delta_idx
        self.prefer_latest_events = prefer_latest_events

        self.height = ECD_HEIGHT
        self.width = ECD_WIDTH
        self.sensor_size = (self.height, self.width)
        self.n_event_deficiency = 0

        seq = self.root_dir / sequence_name
        self.images_dir = seq / "images"
        self.events_path = seq / "events.txt"
        self.image_ts_path = seq / "images.txt"

    def get_ready(self):
        self.load_events()
        self.load_images()
        self.precompute_eval_indices()

    def load_events(self):
        ev = np.loadtxt(self.events_path, delimiter=" ", dtype=np.float64)
        x = ev[:, 1].astype(np.int16)
        y = ev[:, 2].astype(np.int16) - 2  # crop two top rows (ecd_loader.py:56)
        t = ev[:, 0]
        p = ev[:, 3].astype(bool)
        keep = (y >= 0) & (y < ECD_HEIGHT)
        self.events = {"x": x[keep], "y": y[keep], "t": t[keep], "p": p[keep]}

    def load_images(self):
        ts = []
        with open(self.image_ts_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    ts.append(float(line.split(" ")[0]))
        self.image_ts = np.array(ts)
        self.eval_ts = np.array(
            [self.image_ts[: -self.delta_idx], self.image_ts[self.delta_idx :]]
        )
        self.image_paths = sorted(
            str(p) for p in self.images_dir.iterdir() if p.suffix == ".png"
        )

    def precompute_eval_indices(self):
        self.eval_event_start_idxs = np.searchsorted(
            self.events["t"], self.eval_ts[0, :], side="left"
        )
        self.eval_event_end_idxs = np.searchsorted(
            self.events["t"], self.eval_ts[1, :], side="left"
        )
        self.eval_image_start_idxs = np.searchsorted(
            self.image_ts, self.eval_ts[0, :], side="left"
        )
        self.eval_image_end_idxs = np.searchsorted(
            self.image_ts, self.eval_ts[1, :], side="left"
        )

    # shared uint8-grayscale loader (BT.601, matches cv.IMREAD_GRAYSCALE)
    _imread_gray = staticmethod(imread_gray)

    def get_sample(self, eval_idx: int) -> Dict:
        i0 = self.eval_image_start_idxs[eval_idx]
        i1 = self.eval_image_end_idxs[eval_idx]
        paths = self.image_paths[i0 : i1 + 1]
        images = np.array([self._imread_gray(p) for p in paths])
        images = images[:, 2:-2, :]  # crop to 176 rows (ecd_loader.py:94)

        e0 = int(self.eval_event_start_idxs[eval_idx])
        e1 = int(self.eval_event_end_idxs[eval_idx])
        e0, e1, deficiency, orig_n = adjust_event_window(
            e0, e1, self.des_n_events, len(self.events["x"]),
            self.prefer_latest_events,
        )
        self.n_event_deficiency = deficiency

        events = {k: v[e0:e1] for k, v in self.events.items()}
        return {
            "events": events,
            "images": images,
            "image_ts": self.image_ts[i0 : i1 + 1],
            "eval_ts": self.eval_ts[:, eval_idx],
            "n_event_deficiency": deficiency,
            "orig_n_events": orig_n,
        }

    def __getitem__(self, idx):
        return self.get_sample(idx)

    def __len__(self):
        return self.eval_ts.shape[1]
