"""Synthetic event-camera sequences with known ground-truth flow.

The reference has no synthetic data path; SURVEY.md §4 calls for a fake
in-memory loader implementing the datasample dict contract
(dsec_loader.py:327-347) as the test/benchmark fixture. Scenes are moving
point features with constant (or smoothly varying) velocity; ground truth is
exact by construction.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class SyntheticDataLoader:
    """In-memory sequence of event windows from a translating dot field.

    Implements the loader interface: `get_ready()`, `__len__`,
    `__getitem__(i) -> datasample dict` with keys matching the reference
    contract ('events', 'images', 'image_ts', 'flow_gt', 'eval_ts',
    'n_event_deficiency', 'orig_n_events').
    """

    def __init__(
        self,
        sensor_size: Tuple[int, int] = (64, 64),
        n_windows: int = 4,
        des_n_events: int = 8192,
        velocity: Tuple[float, float] = (3.0, -2.0),
        n_features: int = 60,
        window_dt: float = 1.0,
        seed: int = 0,
        prefer_latest_events: bool = True,
        shear: float = 0.0,
    ):
        """`shear` adds a spatially-varying horizontal flow component:
        vx(y) = velocity[0] + shear * (y - H/2), with vy forced to
        velocity[1]. Exactness requires trajectories whose velocity never
        changes, so shear demands velocity[1] == 0 (y constant along each
        feature's path -> vx constant too); ground truth stays exact by
        construction. Gives the solver a genuinely non-constant GT field
        (a 16x16 theta pyramid can represent it) for accuracy studies.
        """
        self.sensor_size = sensor_size
        self.height, self.width = sensor_size
        self.n_windows = n_windows
        self.des_n_events = des_n_events
        self.velocity = np.asarray(velocity, np.float64)
        self.n_features = n_features
        self.window_dt = window_dt
        self.seed = seed
        self.prefer_latest_events = prefer_latest_events
        self.shear = float(shear)
        if self.shear != 0.0 and self.velocity[1] != 0.0:
            raise ValueError(
                "shear mode requires velocity[1] == 0 (y must stay constant "
                "along trajectories for the GT to be exact)"
            )
        self.sequence_name = "synthetic"
        self.n_event_deficiency = 0
        self._ready = False

    def _feature_velocities(self, feats: np.ndarray) -> np.ndarray:
        """(N, 2) per-feature velocity; constant unless shear is set."""
        v = np.broadcast_to(self.velocity, (len(feats), 2)).copy()
        if self.shear:
            v[:, 0] = v[:, 0] + self.shear * (feats[:, 1] - self.height / 2.0)
        return v

    def get_ready(self):
        rng = np.random.default_rng(self.seed)
        h, w = self.sensor_size
        margin = 6
        span = self.n_windows * self.window_dt
        # keep features in-sensor for the whole sequence. The no-shear
        # branch must stay bitwise-identical to the original formula: every
        # seeded fixture (bench workloads, parity harness, recorded bounds)
        # depends on these exact spawn regions.
        if self.shear == 0.0:
            lo = margin + np.maximum(0.0, -self.velocity * span)
            hi = (
                np.array([w, h])
                - margin
                - np.maximum(0.0, self.velocity * span)
            )
        else:
            # |vx| grows with distance from mid-height; bound symmetrically
            # with the sensor-wide worst case
            vx_extreme = abs(self.velocity[0]) + abs(self.shear) * h / 2.0
            v_bound = np.array([vx_extreme, abs(self.velocity[1])])
            lo = margin + v_bound * span
            hi = np.array([w, h]) - margin - v_bound * span
        if not np.all(hi > lo):
            # rng.uniform(lo, hi) with hi < lo silently samples the inverted
            # interval -> off-sensor events under a clean reported GT field
            raise ValueError(
                f"velocity {tuple(self.velocity)} (shear {self.shear}) x "
                f"span {span} exceeds the {self.sensor_size} sensor; "
                "features cannot stay in-sensor (reduce n_windows/window_dt/"
                "|velocity| or grow the sensor)"
            )
        self._features = rng.uniform(lo, hi, size=(self.n_features, 2))
        self._feat_vel = self._feature_velocities(self._features)

        n_total = self.des_n_events * self.n_windows
        ts = np.sort(rng.uniform(0.0, span, n_total))
        which = rng.integers(0, self.n_features, n_total)
        xy = self._features[which] + self._feat_vel[which] * ts[:, None]
        self._events = {
            "x": np.round(xy[:, 0]).astype(np.int16),
            "y": np.round(xy[:, 1]).astype(np.int16),
            "t": ts,
            "p": rng.uniform(0, 1, n_total) > 0.5,
        }
        self._image_ts = np.arange(self.n_windows + 1) * self.window_dt
        self._ready = True

    def _image_at(self, t: float) -> np.ndarray:
        """Grayscale frame: bright dots at feature positions at time t."""
        h, w = self.sensor_size
        img = np.zeros((h, w), np.uint8)
        pos = self._features + self._feat_vel * t
        xi = np.clip(np.round(pos[:, 0]).astype(int), 1, w - 2)
        yi = np.clip(np.round(pos[:, 1]).astype(int), 1, h - 2)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                img[yi + dy, xi + dx] = np.maximum(
                    img[yi + dy, xi + dx], 200 if (dx or dy) else 255
                )
        return img

    def gt_flow_field(self) -> np.ndarray:
        """Exact per-pixel displacement over one window (constant unless
        shear is set, in which case vx varies linearly with y)."""
        h, w = self.sensor_size
        flow = np.zeros((h, w, 2))
        flow[..., 0] = self.velocity[0] * self.window_dt
        flow[..., 1] = self.velocity[1] * self.window_dt
        if self.shear:
            ys = np.arange(h, dtype=np.float64) - h / 2.0
            flow[..., 0] += (self.shear * ys * self.window_dt)[:, None]
        return flow

    def get_sample(self, eval_idx: int) -> Dict:
        assert self._ready, "call get_ready() first"
        t0 = self._image_ts[eval_idx]
        t1 = self._image_ts[eval_idx + 1]
        idx_start = int(np.searchsorted(self._events["t"], t0, side="left"))
        idx_end = int(np.searchsorted(self._events["t"], t1, side="left"))

        from eincm_tpu_torch.data.windowing import adjust_event_window

        idx_start, idx_end, deficiency, orig_n = adjust_event_window(
            idx_start, idx_end, self.des_n_events, len(self._events["t"]),
            self.prefer_latest_events,
        )
        self.n_event_deficiency = deficiency

        events = {
            k: v[idx_start:idx_end] for k, v in self._events.items()
        }
        images = np.stack([self._image_at(t0), self._image_at(t1)])
        return {
            "events": events,
            "images": images,
            "image_ts": np.array([t0, t1]),
            "flow_gt": self.gt_flow_field(),
            "eval_ts": np.array([t0, t1]),
            "n_event_deficiency": deficiency,
            "orig_n_events": orig_n,
        }

    def __getitem__(self, idx):
        return self.get_sample(idx)

    def __len__(self):
        return self.n_windows
