"""MVSEC loader: HDF5 ingest, sensor crop, GT pruning, flow propagation.

Carried over from eincm_tpu/data/mvsec.py (reference:
src/dataloaders/mvsec_loader.py:22-529); the HDF5 file is read by h5py or,
without it, by `utils/h5_lite.py` (data/readers.py). Differences from the
reference:
- the nearest-neighbor `cv.remap` used during ground-truth flow propagation
  (mvsec_loader.py:416-424) is a plain numpy clipped-round gather;
- everything else (crop 260x346 -> 256x336, per-sequence pruning index
  tables, outdoor_day1 hood filter, EV-FlowNet-style temporal flow
  propagation) follows the reference exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from eincm_tpu_torch.data.readers import MVSECReader
from eincm_tpu_torch.data.windowing import adjust_event_window

MVSEC_SEQUENCES = (
    "indoor_flying1",
    "indoor_flying2",
    "indoor_flying3",
    "indoor_flying4",
    "outdoor_day1",
    "outdoor_day2",
    "outdoor_night1",
)

# (start, stop) GT pruning indices per sequence: {seq: (old, new)} where each
# entry is ((start, stop)) — reference mvsec_loader.py:175-197.
_PRUNE_LIMITS = {
    "indoor_flying1": ((60, 1340), (60, 1340)),
    "indoor_flying2": ((140, 1500), (150, 1620)),
    "indoor_flying3": ((100, 1711), (120, 1825)),
    "indoor_flying4": ((60, 380), (104, None)),
    "outdoor_day1": ((0, 5020), (1, 5040)),
    "outdoor_day2": ((30, None), (20, 12145)),
    "outdoor_night1": ((1, 5080), (1, 5080)),
}

MVSEC_HEIGHT = 256
MVSEC_WIDTH = 336


class MVSECDataLoader:
    def __init__(
        self,
        root_dir,
        sequence_name,
        delta_idx: int = 1,
        des_n_events: int = 30_000,
        load_more_images: bool = False,
        use_new_pruning_limits: bool = False,
        prefer_latest_events: bool = True,
    ):
        self.root_dir = Path(root_dir)
        self.sequence_name = sequence_name
        self.delta_idx = delta_idx
        self.des_n_events = des_n_events
        self.load_more_images = load_more_images
        self.use_new_pruning_limits = use_new_pruning_limits
        self.prefer_latest_events = prefer_latest_events
        self.n_event_deficiency = None

        self.height = MVSEC_HEIGHT
        self.width = MVSEC_WIDTH
        self.sensor_size = (self.height, self.width)

        base = sequence_name[:-1]
        self.data_path = self.root_dir / f"hdf5/{base}/{sequence_name}_data.hdf5"
        self.flow_gt_path = (
            self.root_dir / f"Flow GT/{base}/{sequence_name}_gt_flow_dist.npz"
        )

        self._LEFT_DATA_LOADED = False
        self._FLOW_GT_LOADED = False
        self._PRUNED = False

    def get_ready(self):
        self.load_left_data()
        self.load_flow_gt()
        self.prune_data()

    # ------------------------------------------------------------------ load

    def load_left_data(self):
        with MVSECReader(self.data_path) as rdr:
            events = rdr.read_h5_dataset("davis/left/events")
            self.l_image_raw = rdr.read_h5_dataset("davis/left/image_raw")
            self.l_image_raw_event_inds = rdr.read_h5_dataset(
                "davis/left/image_raw_event_inds"
            )
            self.l_image_raw_ts = rdr.read_h5_dataset("davis/left/image_raw_ts")
            self.l_imu = rdr.read_h5_dataset("davis/left/imu")
            self.l_imu_ts = rdr.read_h5_dataset("davis/left/imu_ts")

        # crop events: x-5, y-2 into 336x256 (mvsec_loader.py:113-121)
        xs, ys, ts, ps = events.T
        xs = xs - 5
        ys = ys - 2
        keep = (xs >= 0) & (xs < MVSEC_WIDTH) & (ys >= 0) & (ys < MVSEC_HEIGHT)
        self.l_events = {
            "x": xs[keep].astype(np.int16),
            "y": ys[keep].astype(np.int16),
            "t": ts[keep].astype(np.float64),
            # MVSEC stores polarity as -1/+1; `> 0` keeps the sign. (The
            # reference's `.astype('bool')` at mvsec_loader.py:127 maps -1
            # to True as well — a documented deviation; polarity only feeds
            # plotting, never the loss.)
            "p": ps[keep] > 0,
        }
        # crop images 260x346 -> 256x336
        self.l_image_raw = self.l_image_raw[:, 2:-2, 5:-5]
        self._LEFT_DATA_LOADED = True

    def load_flow_gt(self):
        with MVSECReader(self.flow_gt_path) as rdr:
            if "outdoor_night1" not in self.flow_gt_path.name.lower():
                self.gt_flow_ts = rdr.read_np_array("timestamps")
                self.gt_x_flow_dist = rdr.read_np_array("x_flow_dist")
                self.gt_y_flow_dist = rdr.read_np_array("y_flow_dist")
            else:
                self.gt_flow_ts = rdr.read_np_array("ts")
                self.gt_x_flow_dist = rdr.read_np_array("x_flow_tensor")
                self.gt_y_flow_dist = rdr.read_np_array("y_flow_tensor")

        self.gt_x_flow_dist = self.gt_x_flow_dist[:, 2:-2, 5:-5]
        self.gt_y_flow_dist = self.gt_y_flow_dist[:, 2:-2, 5:-5]
        self._FLOW_GT_LOADED = True

    # ----------------------------------------------------------------- prune

    def prune_data(self):
        assert self.sequence_name.lower() in MVSEC_SEQUENCES
        assert self._LEFT_DATA_LOADED and self._FLOW_GT_LOADED

        old, new = _PRUNE_LIMITS[self.sequence_name.lower()]
        idx_start_gt, idx_stop_gt = new if self.use_new_pruning_limits else old

        self.gt_flow_ts = self.gt_flow_ts[idx_start_gt:idx_stop_gt]
        self.gt_x_flow_dist = self.gt_x_flow_dist[idx_start_gt:idx_stop_gt]
        self.gt_y_flow_dist = self.gt_y_flow_dist[idx_start_gt:idx_stop_gt]

        t = self.l_events["t"]
        n_ev = len(t)
        i0_ev = np.clip(np.searchsorted(t, self.gt_flow_ts[0], "left"), 0, n_ev)
        i1_ev = np.clip(np.searchsorted(t, self.gt_flow_ts[-1], "right"), 0, n_ev)
        i0_img = np.clip(
            np.searchsorted(self.l_image_raw_ts, self.gt_flow_ts[0], "left"),
            0, len(self.l_image_raw),
        )
        i1_img = np.clip(
            np.searchsorted(self.l_image_raw_ts, self.gt_flow_ts[-1], "right"),
            0, len(self.l_image_raw),
        )
        i0_imu = np.clip(
            np.searchsorted(self.l_imu_ts, self.gt_flow_ts[0], "left"),
            0, len(self.l_imu),
        )
        i1_imu = np.clip(
            np.searchsorted(self.l_imu_ts, self.gt_flow_ts[-1], "right"),
            0, len(self.l_imu),
        )

        # event slice covers both GT span and image span (mvsec_loader.py:219-222)
        img_ts = self.l_image_raw_ts
        ev_slice = slice(
            min(i0_ev, np.searchsorted(t, img_ts[min(i0_img, len(img_ts) - 1)])),
            max(i1_ev, np.searchsorted(t, img_ts[min(i1_img, len(img_ts) - 1)])),
        )
        for k in ("x", "y", "t", "p"):
            self.l_events[k] = self.l_events[k][ev_slice]

        if self.sequence_name.lower() == "outdoor_day1":
            # hood-of-car filter (mvsec_loader.py:226-230)
            no_car = self.l_events["y"] < 190
            for k in ("x", "y", "t", "p"):
                self.l_events[k] = self.l_events[k][no_car]

        self.l_image_raw = self.l_image_raw[i0_img:i1_img]
        self.l_image_raw_ts = self.l_image_raw_ts[i0_img:i1_img]
        self.l_image_raw_event_inds = np.searchsorted(
            self.l_events["t"], self.l_image_raw_ts
        )
        self.l_imu = self.l_imu[i0_imu:i1_imu]
        self.l_imu_ts = self.l_imu_ts[i0_imu:i1_imu]
        self._PRUNED = True

    # -------------------------------------------------------------- sampling

    def get_sample_between_two_image_timestamps(self, idx_img: int) -> Dict:
        assert self._LEFT_DATA_LOADED and self._FLOW_GT_LOADED
        # un-pruned timestamps can precede gt_flow_ts[0]; estimate_gt_flow's
        # searchsorted would wrap to the LAST GT frame and return sign-flipped
        # garbage (gt_dt < 0) with no error
        assert self._PRUNED, "call prune_data() before sampling"

        t_start = self.l_image_raw_ts[idx_img]
        t_end = self.l_image_raw_ts[idx_img + self.delta_idx]

        if self.load_more_images:
            images = self.l_image_raw[idx_img : idx_img + self.delta_idx + 1]
            image_ts = self.l_image_raw_ts[idx_img : idx_img + self.delta_idx + 1]
        else:
            images = self.l_image_raw[[idx_img, idx_img + self.delta_idx]]
            image_ts = np.array([t_start, t_end])

        e0 = int(np.searchsorted(self.l_events["t"], t_start, "left"))
        e1 = int(np.searchsorted(self.l_events["t"], t_end, "right"))
        e0, e1, deficiency, orig_n = adjust_event_window(
            e0, e1, self.des_n_events, len(self.l_events["t"]),
            self.prefer_latest_events,
        )
        self.n_event_deficiency = deficiency
        events = {k: v[e0:e1] for k, v in self.l_events.items()}

        m0 = np.searchsorted(self.l_imu_ts, t_start, "left")
        m1 = np.searchsorted(self.l_imu_ts, t_end, "right")

        u_est, v_est = self.estimate_gt_flow(t_start, t_end)
        gt_flow = np.stack([u_est, v_est], axis=-1)

        return {
            "events": events,
            "images": images,
            "image_ts": image_ts,
            "flow_gt": gt_flow,
            "eval_ts": image_ts[[0, -1]],
            "imu": self.l_imu[m0:m1],
            "imu_ts": self.l_imu_ts[m0:m1],
            "n_event_deficiency": deficiency,
            "orig_n_events": orig_n,
        }

    # -------------------------------------------------- GT flow propagation

    def estimate_gt_flow(
        self, t_start: float, t_end: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """EV-FlowNet-style temporal propagation of GT flow
        (mvsec_loader.py:322-408)."""
        idx_gt = np.searchsorted(self.gt_flow_ts, t_start, side="right") - 1
        if idx_gt < 0:
            raise ValueError(
                f"t_start {t_start} precedes the first GT flow frame "
                f"{self.gt_flow_ts[0]} — sequence not pruned?"
            )
        gt_dt = self.gt_flow_ts[idx_gt + 1] - self.gt_flow_ts[idx_gt]
        x_flow = np.squeeze(self.gt_x_flow_dist[idx_gt])
        y_flow = np.squeeze(self.gt_y_flow_dist[idx_gt])
        dt = t_end - t_start
        pre_dt = self.gt_flow_ts[idx_gt + 1] - t_start

        if gt_dt >= dt and pre_dt >= dt:
            return x_flow * dt / gt_dt, y_flow * dt / gt_dt

        x_coords, y_coords = np.meshgrid(
            np.arange(x_flow.shape[1]), np.arange(x_flow.shape[0]), indexing="xy"
        )
        x_coords = x_coords.astype(np.float32)
        y_coords = y_coords.astype(np.float32)
        orig_x = x_coords.copy()
        orig_y = y_coords.copy()
        x_mask = np.ones_like(x_coords, dtype=bool)
        y_mask = np.ones_like(y_coords, dtype=bool)

        self._prop_flow(
            x_flow, y_flow, x_coords, y_coords, x_mask, y_mask, pre_dt / gt_dt
        )

        idx_gt += 1
        while self.gt_flow_ts[idx_gt + 1] < t_end:
            self._prop_flow(
                np.squeeze(self.gt_x_flow_dist[idx_gt]),
                np.squeeze(self.gt_y_flow_dist[idx_gt]),
                x_coords, y_coords, x_mask, y_mask, 1.0,
            )
            idx_gt += 1

        end_dt = t_end - self.gt_flow_ts[idx_gt]
        end_gt_dt = self.gt_flow_ts[idx_gt + 1] - self.gt_flow_ts[idx_gt]
        self._prop_flow(
            np.squeeze(self.gt_x_flow_dist[idx_gt]),
            np.squeeze(self.gt_y_flow_dist[idx_gt]),
            x_coords, y_coords, x_mask, y_mask, end_dt / end_gt_dt,
        )

        x_shift = x_coords - orig_x
        y_shift = y_coords - orig_y
        x_shift[~x_mask] = 0
        y_shift[~y_mask] = 0
        return x_shift, y_shift

    @staticmethod
    def _nearest_remap(field: np.ndarray, xc: np.ndarray, yc: np.ndarray):
        """Nearest-neighbor sample of `field` at float coords; out-of-bounds
        samples return 0 (matches cv.remap INTER_NEAREST + BORDER_CONSTANT)."""
        h, w = field.shape
        xi = np.round(xc).astype(np.int64)
        yi = np.round(yc).astype(np.int64)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.zeros_like(field, dtype=field.dtype)
        out[inside] = field[yi[inside], xi[inside]]
        return out

    def _prop_flow(self, x_flow, y_flow, x_coords, y_coords, x_mask, y_mask,
                   scale_factor=1.0):
        fx = self._nearest_remap(x_flow, x_coords, y_coords)
        fy = self._nearest_remap(y_flow, x_coords, y_coords)
        x_mask[fx == 0] = False
        y_mask[fy == 0] = False
        x_coords += fx * scale_factor
        y_coords += fy * scale_factor

    def __getitem__(self, idx):
        return self.get_sample_between_two_image_timestamps(idx)

    def __len__(self):
        return len(self.l_image_raw_ts) - self.delta_idx
