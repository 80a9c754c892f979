"""Generate DSEC *extended* (continuous) eval-timestamp CSVs.

The official DSEC test eval timestamps cover 100 ms windows at 500 ms
intervals (e.g. 0-100, 500-600, ...). The reference authors densified them
into *continuous* 100 ms windows (0-100, 100-200, ...) and vendored the
result as `docs/assets/dsec_extended_evals/{seq}_.csv`; the DSEC loader's
`extended=True` mode consumes those files from the dataset's
`Evaluation/test_forward_optical_flow_timestamps/` directory
(reference: src/experiments/e00/README.md "DSEC Extended Evaluations",
src/dataloaders/dsec_loader.py:128).

Rather than vendoring derived data, this tool RECONSTRUCTS the extended
files from what every DSEC user already has:

- the official `{seq}.csv` (from_us, to_us, file_index rows), and
- the sequence's image `timestamps.txt` (20 fps, so a 100 ms eval window
  spans exactly 2 images).

Construction rule (verified to reproduce the authors' files bit-exactly on
all 7 vendored sequences — tests/test_dsec_extended_evals.py; this module
is carried over from eincm_tpu/tools/dsec_extended_evals.py and held to it,
tests/test_torch_dsec_tools.py): emit each
official window unchanged; before every official window except the file's
first, insert its four preceding 100 ms windows `[ts[j-2], ts[j], j]` for
j = b-8, b-6, b-4, b-2 — boundaries are the *actual image timestamps*, not
synthetic +100 ms offsets. For contiguous officials (index delta 10) this
fills the 500 ms interval exactly; across official-file discontinuities
(skipped segments, e.g. in interlaken_01_a) the four windows preceding the
new segment's first official are still emitted — matching the authors'
files, whose post-gap runs start with four fill windows.

Usage:
    python -m eincm_tpu_torch.tools.dsec_extended_evals \
        --root_dir /path/to/DSEC --sequence_name thun_01_a
    # or explicit paths:
    python -m eincm_tpu_torch.tools.dsec_extended_evals \
        --eval_ts_path .../thun_01_a.csv \
        --image_ts_path .../timestamps.txt \
        --output_path .../thun_01_a_.csv
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

HEADER = "# from_timestamp_us, to_timestamp_us, file_index"
# images per official eval interval (500 ms at 20 fps) / per 100 ms window
_IDX_PER_INTERVAL = 10
_IDX_PER_WINDOW = 2


def extend_eval_timestamps(
    official: np.ndarray, image_ts_us: np.ndarray
) -> np.ndarray:
    """(N, 3) official [from_us, to_us, file_index] -> (M, 3) extended rows.

    `image_ts_us` is the full image timestamp array; `file_index` indexes it.
    """
    official = np.asarray(official, np.int64)
    image_ts_us = np.asarray(image_ts_us, np.int64)
    assert official.ndim == 2 and official.shape[1] == 3, official.shape
    rows = []
    for k, (frm, to, idx) in enumerate(official):
        if k > 0:
            prev_idx = int(official[k - 1, 2])
            # the 4 windows preceding this official; never overlap the
            # previous official (officials closer than 10 would shorten it)
            j0 = max(prev_idx, int(idx) - _IDX_PER_INTERVAL) + _IDX_PER_WINDOW
            for j in range(j0, int(idx), _IDX_PER_WINDOW):
                rows.append(
                    (
                        int(image_ts_us[j - _IDX_PER_WINDOW]),
                        int(image_ts_us[j]),
                        j,
                    )
                )
        rows.append((int(frm), int(to), int(idx)))
    return np.asarray(rows, np.int64)


def write_extended_csv(rows: np.ndarray, path: Path) -> None:
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for frm, to, idx in rows:
            f.write(f"{frm}, {to}, {idx}\n")


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root_dir", type=Path, default=None)
    ap.add_argument("--sequence_name", type=str, default=None)
    ap.add_argument("--eval_ts_path", type=Path, default=None)
    ap.add_argument("--image_ts_path", type=Path, default=None)
    ap.add_argument("--output_path", type=Path, default=None)
    args = ap.parse_args(argv)

    if args.eval_ts_path is None:
        assert args.root_dir is not None and args.sequence_name is not None, (
            "give either --root_dir + --sequence_name or explicit paths"
        )
        seq = args.sequence_name
        args.eval_ts_path = (
            args.root_dir
            / f"Evaluation/test_forward_optical_flow_timestamps/{seq}.csv"
        )
        args.image_ts_path = (
            args.root_dir / f"Test/test_images/{seq}/images/timestamps.txt"
        )
    if args.output_path is None:
        args.output_path = args.eval_ts_path.with_name(
            args.eval_ts_path.stem + "_.csv"
        )

    official = np.loadtxt(
        args.eval_ts_path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2
    )
    image_ts_us = np.loadtxt(args.image_ts_path, dtype=np.int64)
    rows = extend_eval_timestamps(official, image_ts_us)
    write_extended_csv(rows, args.output_path)
    print(
        f"{args.output_path}: {len(official)} official -> "
        f"{len(rows)} extended windows"
    )
    return args.output_path


if __name__ == "__main__":
    main()
