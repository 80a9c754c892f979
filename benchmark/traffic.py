"""The benchmark's traffic: synthetic event windows and the order of solves.

Frozen copies, so that a change to the program cannot change the yardstick:

- `make_window` is the dot-field model of `eincm_tpu_torch/data/synthetic.py`
  (`SyntheticDataLoader` with one window of unit length and no shear, as
  the port's benchmark builders use it, commit eee0051): features drawn
  uniformly inside a margin that keeps them on the sensor for the window,
  events at uniform times on uniformly chosen features, rounded to pixels,
  grey frames with 3x3 dots at uniform times from the window's start to
  its end, as many as the configuration's loader gives a window
  (`frames_per_window`). The ground truth is the constant velocity, exact
  by construction.
- `walk_position` is the rotating handover walk of
  `eincm_tpu_torch/utils/benchmarks.py`: window k of a chain moves at the
  chain's angle plus k times `rotate_deg`, so the prior that enters a
  window is always `rotate_deg` from its optimum. The chain walks its
  windows forward and back (0, 1, ..., n - 1, n - 2, ..., 1, 0, 1, ...),
  so it can run for as long as the measured window lasts.

A mix file (`traffic/<name>.json`) holds the parameters; nothing here
imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

SEED_MASK = (1 << 64) - 1


def walk_position(step: int, n_windows: int) -> int:
    """The window solved at `step` of a forward-and-back walk over
    `n_windows` windows."""
    if n_windows == 1:
        return 0
    period = 2 * (n_windows - 1)
    p = step % period
    return p if p < n_windows else period - p


def velocity(speed: float, ladder: int, n_ladders: int, k: int,
             rotate_deg: float) -> Tuple[float, float]:
    """Ground-truth velocity (px a window) of window `k` of `ladder`: the
    ladder starts at angle 2 pi ladder / n_ladders and turns `rotate_deg`
    a window."""
    phi = 2.0 * math.pi * ladder / n_ladders + math.radians(rotate_deg) * k
    return speed * math.cos(phi), speed * math.sin(phi)


def frames_per_window(config: Dict) -> int:
    """The frames a window of the configuration holds, as its dataset's
    loader gives them: `assumed.frames_per_window` where the file states
    it (a count that follows from the recording's frame rate and the
    evaluation windows, not from a key of the published config); else
    MVSEC's rule (`eincm_tpu_torch/data/mvsec.py`,
    `get_sample_between_two_image_timestamps`): every frame from the
    window's first to the one `delta_idx` later with `load_more_images`,
    those two alone without."""
    assumed = config.get("assumed", {})
    if "frames_per_window" in assumed:
        return int(assumed["frames_per_window"])
    ds = config["experiment"]["dataset"]
    if "delta_idx" not in ds:
        raise KeyError("the configuration states no frames_per_window and no delta_idx")
    return int(ds["delta_idx"]) + 1 if ds.get("load_more_images", False) else 2


def make_window(sensor: Tuple[int, int], n_events: int, n_features: int,
                vel: Tuple[float, float], seed, n_frames: int) -> Dict:
    """One window of the dot-field model, as the loader's datasample dict
    (`eincm_tpu_torch/data/synthetic.py:get_ready` and `get_sample` with
    n_windows=1, window_dt=1, shear=0), with `n_frames` frames at uniform
    times from the window's start to its end. `seed` is anything
    `np.random.default_rng` takes."""
    rng = np.random.default_rng(seed)
    h, w = sensor
    v = np.asarray(vel, np.float64)
    margin = 6
    span = 1.0
    lo = margin + np.maximum(0.0, -v * span)
    hi = np.array([w, h]) - margin - np.maximum(0.0, v * span)
    if not np.all(hi > lo):
        raise ValueError(f"velocity {tuple(v)} leaves no room on the {sensor} sensor")
    features = rng.uniform(lo, hi, size=(n_features, 2))
    ts = np.sort(rng.uniform(0.0, span, n_events))
    which = rng.integers(0, n_features, n_events)
    xy = features[which] + v[None, :] * ts[:, None]
    events = {
        "x": np.round(xy[:, 0]).astype(np.int16),
        "y": np.round(xy[:, 1]).astype(np.int16),
        "t": ts,
        "p": rng.uniform(0, 1, n_events) > 0.5,
    }
    image_ts = np.linspace(0.0, span, n_frames)
    images = np.stack([_image_at(features, v, t, sensor) for t in image_ts])
    flow = np.empty((h, w, 2))
    flow[..., 0], flow[..., 1] = v[0], v[1]
    return {
        "events": events,
        "images": images,
        "image_ts": image_ts,
        "flow_gt": flow,
        "eval_ts": np.array([0.0, span]),
        "n_event_deficiency": 0,
        "orig_n_events": n_events,
    }


def _image_at(features: np.ndarray, v: np.ndarray, t: float, sensor) -> np.ndarray:
    """Grey frame: bright 3x3 dots at the feature positions at time t."""
    h, w = sensor
    img = np.zeros((h, w), np.uint8)
    pos = features + v * t
    xi = np.clip(np.round(pos[:, 0]).astype(int), 1, w - 2)
    yi = np.clip(np.round(pos[:, 1]).astype(int), 1, h - 2)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            img[yi + dy, xi + dx] = np.maximum(img[yi + dy, xi + dx],
                                               200 if (dx or dy) else 255)
    return img


class ChainPlan:
    """What one chain solves in a run of a mix.

    The mix is a fixed set of walks: ladder l walks its windows from
    position `start_step` * l of the forward-and-back walk, and window k of
    ladder l is drawn from (`pool_seed`, l, k). The run's seed decides the
    order, which chain walks which ladder, and which windows the check
    compares. So every seed gives the same work in another order: the
    windows a chain solves cost alike from seed to seed, and the AEE of a
    run is that of the same windows."""

    def __init__(self, mix: Dict, config: Dict, seed: int, chain: int):
        self.mix = mix
        self.n_windows = int(mix["windows_per_chain"])
        self.n_chains = int(mix["chains"])
        rng = np.random.default_rng([int(seed) & SEED_MASK, 0x6D6978])
        self.chain = chain
        self.ladder = int(rng.permutation(self.n_chains)[chain])
        self.start = int(mix["start_step"]) * self.ladder
        self.seed = int(seed)
        ds = config["experiment"]["dataset"]
        self.sensor = tuple(int(s) for s in ds["sensor_size"])
        self.n_events = int(ds["des_n_events"])
        assumed = config["assumed"]
        self.n_features = int(assumed["n_features"])
        self.speed = float(assumed["speed_px"])
        self.n_frames = frames_per_window(config)

    def velocity(self, k: int) -> Tuple[float, float]:
        return velocity(self.speed, self.ladder, self.n_chains, k,
                        float(self.mix["rotate_deg"]))

    def window(self, k: int) -> Dict:
        seed = [int(self.mix["pool_seed"]) & SEED_MASK, self.ladder, k]
        return make_window(self.sensor, self.n_events, self.n_features,
                           self.velocity(k), seed, self.n_frames)

    def position(self, step: int) -> int:
        """The window at `step` of this chain's walk (step 0: the first
        warm-up window)."""
        return walk_position(self.start + step, self.n_windows)

    def compare_sample(self, n_done: int) -> List[int]:
        """Indices (into this chain's timed windows) that the check
        compares, drawn from the run's seed."""
        k = min(int(self.mix["compare_windows_per_chain"]), n_done)
        rng = np.random.default_rng([self.seed & SEED_MASK, 0x636D70, self.chain])
        return sorted(int(i) for i in rng.choice(n_done, size=k, replace=False))
