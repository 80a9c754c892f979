"""Seeded on-disk dataset trees in the DSEC, MVSEC and ECD layouts.

Each writer lays out the files its loader reads (`data/dsec.py`,
`data/mvsec.py`, `data/ecd.py`) for a scene of bright dots moving at a
known velocity (`data/synthetic.py`'s generator), so a run over the tree
can be scored against the truth. HDF5 goes through `utils/h5_lite.py`,
PNGs through `utils/png16.py`, the rest is plain text: no h5py, PIL or
PyYAML is needed, and nothing is downloaded.

- DSEC (train or test split): 100 ms windows at 20 fps (three frames a
  window), events as uint16 x, y, int64 microseconds and uint8 polarity
  with `ms_to_idx` and a scalar `t_offset`; a float32 rectify map that
  shifts by whole pixels plus a smooth sub-pixel wobble (so rectification
  is exact on the dots); a `cam_to_cam.yaml` in block sequences with
  distortion (its homography between the rectified cameras is the identity);
  8-bit RGB frames; GT flow PNGs (train) or an official eval CSV (test).
- MVSEC (`{seq}_data.hdf5`, `Flow GT/...npz`) at 260x346: the 256x336 crop
  holds a shear scene, vx(y) = vx0 + shear (y - 128), vy = 0, so the GT is
  spatially varying; GT frames and images share timestamps, and the solved
  windows start at the sequence's pruning limit.
- ECD (`events.txt`, `images.txt`, `images/`) at 240x180 (the loader
  crops to 176 rows). ECD has no GT: the writer returns the velocity.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
from eincm_tpu_torch.utils.h5_lite import write_h5
from eincm_tpu_torch.utils.png16 import write_png16

DSEC_SEQ = "synthetic_dots_a"
DSEC_WINDOW_US = 100_000  # one eval window: two frame intervals at 20 fps
DSEC_T_OFFSET = 50_000_000
DSEC_SHIFT = (2, -1)  # the rectify map's whole-pixel shift (x, y)
DSEC_VELOCITY = (6.0, -4.0)  # px per window; a multiple of 1/128 (the GT PNG's unit)
MVSEC_SEQ = "indoor_flying1"
MVSEC_PRUNE_START = 60  # indoor_flying1's first kept GT frame (data/mvsec.py)
MVSEC_DELTA_IDX = 4  # configs/mvsec_indoor.yaml: a window is 4 frame intervals
ECD_SEQ = "slider_dots"


def _scene(sensor, n_windows, events_per_window, velocity, n_features, seed, shear=0.0):
    dl = SyntheticDataLoader(sensor_size=tuple(sensor), n_windows=n_windows,
                             des_n_events=events_per_window, velocity=velocity,
                             n_features=n_features, seed=seed, shear=shear)
    dl.get_ready()
    return dl


def _rgb(grey: np.ndarray) -> np.ndarray:
    return np.repeat(grey[..., None], 3, axis=-1)


def _yaml_float(v) -> str:
    """A float as `yaml.safe_dump` writes it (YAML 1.1 needs the dot: 1e-05
    would be a string)."""
    text = repr(float(v))
    return text.replace("e", ".0e") if "e" in text and "." not in text else text


def _block_list(rows, indent: str) -> str:
    """A matrix as `yaml.safe_dump` writes it: nested block sequences."""
    lines = []
    for row in rows:
        cells = [_yaml_float(v) for v in row]
        lines.append(f"{indent}- - {cells[0]}")
        lines += [f"{indent}  - {c}" for c in cells[1:]]
    return "\n".join(lines)


def _cam_to_cam(h: int, w: int) -> str:
    """Calibration with distortion whose rectified cameras share intrinsics
    and rotation, so the image homography is the identity (to rounding)."""
    rot = np.array([[0.9998, -0.0175, 0.0087], [0.0174, 0.9998, 0.0088],
                    [-0.0089, -0.0086, 0.9999]])
    u, _, vt = np.linalg.svd(rot)
    rot = u @ vt  # an exact rotation
    t10 = np.eye(4)
    t10[:3, 3] = [-0.6, 0.002, 0.01]  # a stereo baseline; rotation-free
    k_rect = [560.0, 560.0, w / 2.0, h / 2.0]
    return "\n".join([
        "extrinsics:",
        "  R_rect0:", _block_list(rot, "  "),
        "  R_rect1:", _block_list(rot, "  "),
        "  T_10:", _block_list(t10, "  "),
        "intrinsics:",
        "  cam0:",
        "    camera_matrix:", *[f"    - {_yaml_float(v)}" for v in [553.4, 553.9, w / 2.0 + 3.1, h / 2.0 - 2.2]],
        "    distortion_coeffs:", *[f"    - {_yaml_float(v)}" for v in [-0.0786, 0.1409, 0.0011, -0.0005]],
        "  camRect0:",
        "    camera_matrix:", *[f"    - {_yaml_float(v)}" for v in k_rect],
        "  camRect1:",
        "    camera_matrix:", *[f"    - {_yaml_float(v)}" for v in k_rect],
        "",
    ])


def write_dsec_tree(root, split: str = "train", sensor: Tuple[int, int] = (480, 640),
                    n_windows: int = 4, events_per_window: int = 1_600_000,
                    velocity: Tuple[float, float] = DSEC_VELOCITY, n_features: int = 700,
                    seed: int = 3) -> Dict:
    """A DSEC tree of `n_windows` 100 ms windows. Returns its description:
    root, sequence, velocity (px per window), sensor, the events written,
    and for the test split the official CSV's path."""
    root = Path(root)
    h, w = sensor
    split_dir = {"train": "Train/train", "test": "Test/test"}[split]
    ev_dir = root / f"{split_dir}_events/{DSEC_SEQ}/events/left"
    img_dir = root / f"{split_dir}_images/{DSEC_SEQ}/images"
    cal_dir = root / f"{split_dir}_calibration/{DSEC_SEQ}/calibration"
    for d in (ev_dir, img_dir / "left/rectified", cal_dir):
        d.mkdir(parents=True, exist_ok=True)

    dl = _scene(sensor, n_windows, events_per_window, velocity, n_features, seed)
    ev = dl._events
    sx, sy = DSEC_SHIFT
    raw_x, raw_y = ev["x"].astype(np.int64) - sx, ev["y"].astype(np.int64) - sy
    keep = (raw_x >= 0) & (raw_x < w) & (raw_y >= 0) & (raw_y < h)
    t_us = np.round(ev["t"][keep] * DSEC_WINDOW_US).astype(np.int64)
    span_ms = int(n_windows * DSEC_WINDOW_US // 1000) + 1
    write_h5(ev_dir / "events.h5", {
        "events/x": raw_x[keep].astype(np.uint16), "events/y": raw_y[keep].astype(np.uint16),
        "events/t": t_us, "events/p": ev["p"][keep].astype(np.uint8),
        "ms_to_idx": np.searchsorted(t_us, np.arange(span_ms) * 1000).astype(np.uint64),
        "t_offset": np.int64(DSEC_T_OFFSET),
    })
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    rect = np.stack([gx + sx + 0.3 * np.sin(gy / 23.0), gy + sy + 0.3 * np.cos(gx / 31.0)],
                    axis=-1).astype(np.float32)
    write_h5(ev_dir / "rectify_map.h5", {"rectify_map": rect})
    (cal_dir / "cam_to_cam.yaml").write_text(_cam_to_cam(h, w))

    n_images = 2 * n_windows + 1
    img_ts = DSEC_T_OFFSET + np.arange(n_images, dtype=np.int64) * (DSEC_WINDOW_US // 2)
    np.savetxt(img_dir / "timestamps.txt", img_ts, fmt="%d")
    for i in range(n_images):
        write_png16(img_dir / "left/rectified" / f"{i:06d}.png", _rgb(dl._image_at(i / 2.0)))

    out = {"root": root, "sequence": DSEC_SEQ, "velocity": tuple(velocity),
           "sensor": (h, w), "n_events": int(keep.sum()), "n_windows": n_windows}
    if split == "train":
        flow_dir = root / f"Train/train_optical_flow/{DSEC_SEQ}/flow"
        (flow_dir / "forward").mkdir(parents=True, exist_ok=True)
        with open(flow_dir / "forward_timestamps.txt", "w") as f:
            f.write("# from_timestamp_us, to_timestamp_us\n")
            for i in range(n_windows):
                f.write(f"{img_ts[2 * i]}, {img_ts[2 * i + 2]}\n")
        enc = np.zeros((h, w, 3), np.uint16)
        enc[..., 0] = round(velocity[0] * 128 + 2**15)
        enc[..., 1] = round(velocity[1] * 128 + 2**15)
        enc[..., 2] = 1
        for i in range(n_windows):
            write_png16(flow_dir / "forward" / f"{i:06d}.png", enc)
    else:
        # official windows [ts[j-2], ts[j]] at the first and last window
        eval_dir = root / "Evaluation/test_forward_optical_flow_timestamps"
        eval_dir.mkdir(parents=True, exist_ok=True)
        csv = eval_dir / f"{DSEC_SEQ}.csv"
        with open(csv, "w") as f:
            f.write("# from_timestamp_us, to_timestamp_us, file_index\n")
            for j in sorted({2, 2 * n_windows}):
                f.write(f"{img_ts[j - 2]}, {img_ts[j]}, {j}\n")
        out["official_csv"] = csv
    return out


def write_mvsec_tree(root, n_windows: int = 3, events_per_window: int = 30_000,
                     vx0: float = 5.0, shear: float = 0.01, n_features: int = 120,
                     seed: int = 5, frame_dt: float = 0.0315) -> Dict:
    """An MVSEC indoor_flying1 tree: GT frames and images every `frame_dt`
    seconds, events of `n_windows` windows of MVSEC_DELTA_IDX frames from
    the pruning limit on. Velocities are px per window."""
    root = Path(root)
    base = MVSEC_SEQ[:-1]
    (root / f"hdf5/{base}").mkdir(parents=True, exist_ok=True)
    (root / f"Flow GT/{base}").mkdir(parents=True, exist_ok=True)
    h, w = 256, 336  # the crop's sensor; raw 260x346 with x + 5, y + 2
    dl = _scene((h, w), n_windows, events_per_window, (vx0, 0.0), n_features, seed, shear)
    ev = dl._events
    n_frames = MVSEC_PRUNE_START + MVSEC_DELTA_IDX * n_windows + 2
    t0 = 1_500_000_000.0  # seconds, like MVSEC's ROS clock
    frame_ts = t0 + np.arange(n_frames) * frame_dt
    window_s = MVSEC_DELTA_IDX * frame_dt
    start = frame_ts[MVSEC_PRUNE_START]
    ts = start + ev["t"] * window_s
    pol = np.where(ev["p"], 1.0, -1.0)
    events = np.stack([ev["x"] + 5.0, ev["y"] + 2.0, ts, pol], axis=-1)
    images = np.zeros((n_frames, 260, 346), np.uint8)
    for k in range(n_frames):
        images[k, 2:-2, 5:-5] = dl._image_at(max(0.0, (k - MVSEC_PRUNE_START) / MVSEC_DELTA_IDX))
    rng = np.random.default_rng(seed + 1)
    write_h5(root / f"hdf5/{base}/{MVSEC_SEQ}_data.hdf5", {
        "davis/left/events": events, "davis/left/image_raw": images,
        "davis/left/image_raw_event_inds": np.searchsorted(ts, frame_ts),
        "davis/left/image_raw_ts": frame_ts,
        "davis/left/imu": rng.normal(0, 1, (4 * n_frames, 6)),
        "davis/left/imu_ts": np.linspace(frame_ts[0], frame_ts[-1], 4 * n_frames),
    })
    # GT displacement per frame interval: the window's flow / MVSEC_DELTA_IDX
    rows = np.arange(260) - 2.0 - h / 2.0
    x_gt = np.zeros((n_frames, 260, 346))
    x_gt[:] = ((vx0 + shear * rows) / MVSEC_DELTA_IDX)[None, :, None]
    np.savez(root / f"Flow GT/{base}/{MVSEC_SEQ}_gt_flow_dist.npz",
             timestamps=frame_ts, x_flow_dist=x_gt, y_flow_dist=np.zeros_like(x_gt))
    return {"root": root, "sequence": MVSEC_SEQ, "velocity": (vx0, 0.0), "shear": shear,
            "sensor": (h, w), "n_events": len(ts), "n_windows": n_windows}


def write_ecd_tree(root, n_windows: int = 3, events_per_window: int = 30_000,
                   velocity: Tuple[float, float] = (4.0, -2.0), n_features: int = 80,
                   seed: int = 7, frame_dt: float = 0.05) -> Dict:
    """An ECD sequence: one window between consecutive frames."""
    root = Path(root)
    seq = root / ECD_SEQ
    (seq / "images").mkdir(parents=True, exist_ok=True)
    h, w = 176, 240  # the crop; the raw sensor has 180 rows (y + 2)
    dl = _scene((h, w), n_windows, events_per_window, velocity, n_features, seed)
    ev = dl._events
    ts = ev["t"] * frame_dt
    lines = [f"{t:.9f} {x} {y} {int(p)}" for t, x, y, p in
             zip(ts, ev["x"].tolist(), (ev["y"] + 2).tolist(), ev["p"].tolist())]
    (seq / "events.txt").write_text("\n".join(lines) + "\n")
    with open(seq / "images.txt", "w") as f:
        for i in range(n_windows + 1):
            f.write(f"{i * frame_dt:.9f} images/frame_{i:08d}.png\n")
            frame = np.zeros((180, w), np.uint8)
            frame[2:-2] = dl._image_at(float(i))
            write_png16(seq / "images" / f"frame_{i:08d}.png", frame)
    return {"root": root, "sequence": ECD_SEQ, "velocity": tuple(velocity),
            "sensor": (h, w), "n_events": len(ts), "n_windows": n_windows}
