"""DSEC benchmark submission exporter: opt_results.npz -> uint16 flow PNGs.

Carried over from eincm_tpu/tools/dsec_submission.py (reference:
src/dsec_npz_to_png.py:29-101): for each solved window, upscale the finest
theta to 480x640 (the port's `ops/resize.py`, on `--device`, default cuda),
encode as uint16 = flow * 128 + 2^15 (valid channel = 1), and write
{file_idx:06d}.png.

Usage:
    python -m eincm_tpu_torch.tools.dsec_submission \\
        --sequence_name zurich_city_12_a \\
        --opt_results_path outputs/.../opt_results.npz \\
        --eval_ts_path .../zurich_city_12_a.csv \\
        --output_dir submission/ [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.utils.png16 import write_png16

DSEC_SENSOR = (480, 640)


def theta_to_submission_png(theta: np.ndarray, device="cuda") -> np.ndarray:
    """(h, w, 2) theta -> (480, 640, 3) uint16 DSEC encoding."""
    flow = scale_theta_to_sensor_size(
        torch.as_tensor(np.asarray(theta), device=torch.device(device)),
        DSEC_SENSOR, "bilinear",
    ).cpu().numpy()
    enc = np.zeros((*DSEC_SENSOR, 3), np.uint16)
    enc[..., 0] = np.clip(flow[..., 0] * 128.0 + 2**15, 0, 65535).astype(
        np.uint16
    )
    enc[..., 1] = np.clip(flow[..., 1] * 128.0 + 2**15, 0, 65535).astype(
        np.uint16
    )
    enc[..., 2] = 1
    return enc


def export_submission(
    opt_results_path,
    eval_ts_path,
    output_dir,
    skip: int = 0,
    jump_first: int = 0,
    sequence_name: str = "",
    device="cuda",
):
    """Write one PNG per eval timestamp row, named by its file_idx column.

    With `sequence_name`, PNGs land in `output_dir/sequence_name/` — the
    layout the DSEC benchmark upload expects (dsec_npz_to_png.py:50).
    """
    out = Path(output_dir) / sequence_name if sequence_name else Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    opt_results = EINCMOutputLoader().load_opt_results(
        opt_results_path, run_validation=False
    )
    eval_ts = np.loadtxt(
        eval_ts_path, delimiter=",", skiprows=1, dtype="int64", ndmin=2
    )

    keys = sorted(
        opt_results, key=lambda k: int(k.replace("datasample_idx_", ""))
    )
    if jump_first:
        keys = keys[jump_first:]
    if skip:
        keys = keys[:: skip + 1]

    written = []
    for key in keys:
        idx = int(key.replace("datasample_idx_", ""))
        theta = np.asarray(
            opt_results[key]["solver_final_results"]["final_theta_pyr"][
                "pyr_lvl_0"
            ]
        )
        enc = theta_to_submission_png(theta, device)
        file_idx = int(eval_ts[idx, 2])
        path = out / f"{file_idx:06d}.png"
        write_png16(path, enc)
        written.append(path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sequence_name", required=False, default="")
    p.add_argument("--opt_results_path", required=True)
    p.add_argument("--eval_ts_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--skip", type=int, default=0)
    p.add_argument("--jump_first", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the upscale (default cuda)")
    args = p.parse_args(argv)
    written = export_submission(
        args.opt_results_path, args.eval_ts_path, args.output_dir,
        args.skip, args.jump_first, args.sequence_name, args.device,
    )
    print(f"wrote {len(written)} submission PNGs to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
