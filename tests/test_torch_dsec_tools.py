"""The port's DSEC tools (eincm_tpu_torch/tools/) against the JAX package's:
the extended eval CSVs equal, and the submission PNGs equal but for float32
rounding. The port upscales theta with PyTorch, the JAX package with
`jax.image`; the two float32 flows differ in the last place, so where
flow * 128 lands next to an integer the uint16 encodings differ by one
count: on at most 1e-4 of the values (measured: 3.1e-5 at most over 20
random thetas, N(0, 6^2) px, 16x16)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from eincm_tpu.tools import dsec_extended_evals as jext
from eincm_tpu.tools import dsec_submission as jsub
from eincm_tpu_torch.tools import dsec_extended_evals as text
from eincm_tpu_torch.tools import dsec_submission as tsub
from eincm_tpu_torch.experiments.outputs import save_opt_results
from eincm_tpu_torch.utils import dataset_trees
from eincm_tpu_torch.utils.png16 import read_png16


def _sequence(n_images, seed, gap=False):
    rng = np.random.default_rng(seed)
    ts = 10_000_000 + np.cumsum(rng.integers(49_900, 50_100, n_images)).astype(np.int64)
    idx = np.arange(10, n_images, 10, dtype=np.int64)
    if gap:  # a skipped segment, as in interlaken_01_a
        idx = idx[idx != 30]
    return ts, np.stack([ts[idx - 2], ts[idx], idx], axis=1)


@pytest.mark.parametrize("n_images,seed,gap", [(61, 0, False), (81, 1, True), (12, 2, False)])
def test_extended_rows_match_jax(n_images, seed, gap):
    ts, official = _sequence(n_images, seed, gap)
    got = text.extend_eval_timestamps(official, ts)
    np.testing.assert_array_equal(got, jext.extend_eval_timestamps(official, ts))
    assert got.dtype == np.int64


def test_extended_csv_cli_matches_jax(tmp_path):
    ts, official = _sequence(61, 3)
    (tmp_path / "official.csv").write_text(
        jext.HEADER + "\n" + "".join(f"{a}, {b}, {c}\n" for a, b, c in official))
    np.savetxt(tmp_path / "timestamps.txt", ts, fmt="%d")
    args = ["--eval_ts_path", str(tmp_path / "official.csv"),
            "--image_ts_path", str(tmp_path / "timestamps.txt")]
    got = text.main([*args, "--output_path", str(tmp_path / "port_.csv")])
    ref = jext.main([*args, "--output_path", str(tmp_path / "jax_.csv")])
    assert Path(got).read_text() == Path(ref).read_text()
    # the default output path and the --root_dir form, on a written test tree
    tree = dataset_trees.write_dsec_tree(tmp_path / "dsec", "test", sensor=(48, 64),
                                         n_windows=4, events_per_window=500, n_features=10)
    out = text.main(["--root_dir", str(tree["root"]), "--sequence_name", tree["sequence"]])
    assert out.name == f"{tree['sequence']}_.csv"
    rows = np.loadtxt(out, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    assert rows[:, 2].tolist() == [2, 4, 6, 8]


def _opt_results(path, thetas):
    rec = {f"datasample_idx_{i}": {"solver_final_results": {
        "final_theta_pyr": {"pyr_lvl_0": th, "pyr_lvl_1": th[::2, ::2]}}}
        for i, th in enumerate(thetas)}
    save_opt_results(path, rec)


def test_submission_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    thetas = [rng.normal(0, 6, (16, 16, 2)).astype(np.float32) for _ in range(3)]
    thetas.append(np.full((16, 16, 2), 300.0, np.float32))  # clipped at 65535
    _opt_results(tmp_path / "opt_results.npz", thetas)
    csv = tmp_path / "seq_.csv"
    csv.write_text("# from, to, file_index\n" + "".join(
        f"{100 * i}, {100 * i + 100}, {10 + 2 * i}\n" for i in range(4)))
    args = ["--opt_results_path", str(tmp_path / "opt_results.npz"), "--eval_ts_path", str(csv),
            "--sequence_name", "seq", "--skip", "0"]
    got = tsub.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jsub.main([*args, "--output_dir", str(tmp_path / "jax")])
    assert [p.name for p in got] == ["000010.png", "000012.png", "000014.png", "000016.png"]
    for p in got:
        a, b = read_png16(p), read_png16(tmp_path / "jax" / "seq" / p.name)
        assert a.dtype == np.uint16 and a.shape == (480, 640, 3)
        d = np.abs(a.astype(np.int64) - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())
        np.testing.assert_array_equal(a[..., 2], b[..., 2])
    assert (read_png16(got[-1])[..., :2] == 65535).all()


@pytest.mark.parametrize("skip,jump_first", [(1, 0), (0, 2)])
def test_submission_skip_and_jump(tmp_path, skip, jump_first):
    thetas = [np.full((4, 4, 2), float(i), np.float32) for i in range(5)]
    _opt_results(tmp_path / "opt.npz", thetas)
    csv = tmp_path / "e.csv"
    csv.write_text("# h\n" + "".join(f"0, 1, {i}\n" for i in range(5)))
    got = tsub.export_submission(tmp_path / "opt.npz", csv, tmp_path / "o", skip, jump_first,
                                 device="cpu")
    ref = jsub.export_submission(tmp_path / "opt.npz", csv, tmp_path / "j", skip, jump_first)
    assert [p.name for p in got] == [p.name for p in ref]


def test_submission_png_encoding(tmp_path):
    """theta -> PNG is the port's upscale, then flow * 128 + 2^15."""
    theta = np.random.default_rng(5).normal(0, 3, (8, 8, 2)).astype(np.float32)
    enc = tsub.theta_to_submission_png(theta, "cpu")
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    flow = scale_theta_to_sensor_size(torch.as_tensor(theta), (480, 640)).numpy()
    np.testing.assert_array_equal(enc[..., 0], (flow[..., 0] * 128.0 + 2**15).astype(np.uint16))
    np.testing.assert_array_equal(enc[..., 2], 1)
    with pytest.raises((RuntimeError, AssertionError)):  # no card here
        tsub.theta_to_submission_png(theta)  # the default device is the card
