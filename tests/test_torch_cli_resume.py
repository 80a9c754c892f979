"""The port's CLI killed and resumed, on a DSEC tree on disk: the mirror of
tests/test_full_pipeline.py::test_dsec_quarter_scale_cli_kill_resume
through `python -m eincm_tpu_torch.experiments --device cpu`.

SOLVE runs in a subprocess that is SIGKILLed as soon as a loadable
checkpoint lands; a second invocation resumes from it through
`phases.run_from_checkpoint` (only the later windows solved, the restored
records bitwise the checkpoint's, the first resumed window's level-0
prior bitwise the checkpoint's last final); an EVAL/PLOT-only invocation loads the
results; the DSEC submission tool exports them. Two sizes: a small tree in
tier 1, and the JAX test's quarter-scale tree (240x320, 150k events)
marked slow, as that test is.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("h5py")  # tests/dataset_fixtures.py writes the tree with it

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 900


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def _loadable(path) -> bool:
    """A checkpoint counts once it loads: the file may be mid-write."""
    try:
        with np.load(path, allow_pickle=True) as z:
            z["opt_results"].item()
        return True
    except Exception:
        return False


def solve_killed(args, ckpt_dir, log):
    """Start the CLI's SOLVE in a subprocess (its output to `log`) and
    SIGKILL it once a loadable checkpoint lands. Returns (the checkpoint,
    whether it was killed); a run that finished first leaves its first
    checkpoint (kept at the end)."""
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eincm_tpu_torch.experiments", *args], cwd=REPO,
            env=_env(), stdout=out, stderr=subprocess.STDOUT)
        deadline = time.time() + DEADLINE_S
        ckpt = None
        try:
            while time.time() < deadline and proc.poll() is None:
                landed = [p for p in sorted(ckpt_dir.glob("checkpoint_*.npz")) if _loadable(p)]
                if landed:
                    ckpt = landed[0]
                    break
                time.sleep(0.02)
        finally:
            killed = proc.poll() is None
            if killed:
                proc.send_signal(signal.SIGKILL)  # the abrupt death resume exists for
            proc.wait()
    if not killed:
        assert proc.returncode == 0, Path(log).read_text()[-4000:]
        ckpt = sorted(ckpt_dir.glob("checkpoint_*.npz"))[0]
    return ckpt, killed


def kill_resume(tmp_path, sensor, n_ev, des_n_events, solver):
    from dataset_fixtures import make_dsec_tree

    from eincm_tpu_torch.experiments.__main__ import main
    from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader
    from eincm_tpu_torch.tools.dsec_submission import main as sub_main
    from eincm_tpu_torch.tools.dsec_submission import theta_to_submission_png
    from eincm_tpu_torch.utils.png16 import read_png16

    root, seq = make_dsec_tree(tmp_path / "dsec", sensor=sensor, n_ev=n_ev, n_eval_windows=3)
    out = tmp_path / "out"
    common = [
        "--device", "cpu", f"output_dir={out}", "experiment_name=dsec_q",
        "dataset.kind=dsec", f"dataset.root_dir={root}", f"dataset.sequence_name={seq}",
        "dataset.data_split=train", f"dataset.des_n_events={des_n_events}",
        f"dataset.sensor_size=[{sensor[0]},{sensor[1]}]", *solver,
        "edge.enable_image_preprocessing=false", "alpha=2000", "beta=4000",
        "phases.checkpoint_every_percent=30", "phases.delete_checkpoints_at_end=false",
    ]
    solve_args = common + ["phases.solve=true", "phases.eval=false", "phases.plot=false"]

    # ---- SOLVE in a subprocess, killed once its first checkpoint landed ----
    ckpt, killed = solve_killed(solve_args, out / "dsec_q" / "checkpoints",
                                tmp_path / "solve.log")
    saved = EINCMOutputLoader().load_opt_results(str(ckpt))
    last = max(int(k.rsplit("_", 1)[1]) for k in saved)
    assert sorted(saved) == [f"datasample_idx_{i}" for i in range(last + 1)]
    if killed:
        assert not (out / "dsec_q" / "opt_results.npz").exists()

    # ---- resume through the same CLI: only the later windows solved -------
    exp = main(solve_args + [f"phases.run_from_checkpoint={ckpt}"])
    assert sorted(exp.opt_results) == [f"datasample_idx_{i}" for i in range(3)]
    assert sorted(i for i, st in exp.stats.items() if "solve_ms" in st) == list(range(last + 1, 3))
    for key, rec in saved.items():  # restored, not re-solved
        np.testing.assert_array_equal(
            exp.opt_results[key]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"],
            rec["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"])
    if last < 2:  # the coarser priors are downscaled from the finest
        nxt = exp.opt_results[f"datasample_idx_{last + 1}"]["solver_final_results"]
        prev = saved[f"datasample_idx_{last}"]["solver_final_results"]["final_theta_pyr"]
        np.testing.assert_array_equal(nxt["prior_theta_pyr"]["pyr_lvl_0"], prev["pyr_lvl_0"])
    exp_dir = out / "dsec_q"
    opt = EINCMOutputLoader().load_opt_results(str(exp_dir / "opt_results.npz"))
    assert len(opt) == 3

    # ---- EVAL/PLOT alone: it loads opt_results.npz --------------------------
    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401
        plot = "true"
    except ImportError:
        plot = "false"
    exp2 = main(common + ["phases.solve=false", "phases.eval=true", f"phases.plot={plot}"])
    assert len(exp2.eval_results) == 3
    assert all(np.isfinite(float(np.asarray(r["evals"]["AEE"])))
               for r in exp2.eval_results.values())
    scores = (exp_dir / "scores.txt").read_text()
    assert "AEE" in scores and "loss:" in scores
    if plot == "true":
        assert list((exp_dir / "plots").glob("*.png")) and list((exp_dir / "plots").glob("*.avi"))

    # ---- the submission export over the resumed results --------------------
    csv = tmp_path / f"{seq}.csv"
    csv.write_text("# from, to, file_idx\n1000000,1100000,10\n1100000,1200000,20\n"
                   "1200000,1300000,30\n")
    sub_main(["--sequence_name", seq, "--opt_results_path", str(exp_dir / "opt_results.npz"),
              "--eval_ts_path", str(csv), "--output_dir", str(tmp_path / "submission"),
              "--device", "cpu"])
    pngs = sorted((tmp_path / "submission" / seq).glob("*.png"))
    assert [p.name for p in pngs] == ["000010.png", "000020.png", "000030.png"]
    theta = opt["datasample_idx_0"]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"]
    np.testing.assert_array_equal(read_png16(pngs[0]), theta_to_submission_png(theta, "cpu"))
    return killed


def test_cli_killed_and_resumed_small(tmp_path):
    """A small tree (96x128, 3 windows of 1500 events, 3 levels): the
    subprocess is killed after window 0's checkpoint."""
    killed = kill_resume(tmp_path, (96, 128), 9000, 1500,
                         ["solver.n_pyr_lvls=3", "solver.theta_maxiter=6",
                          "solver.theta_miniter=3", "solver.handover_maxiter=4",
                          "solver.max_ls_evals=4"])
    assert killed


@pytest.mark.slow
def test_cli_killed_and_resumed_quarter_scale(tmp_path):
    """tests/test_full_pipeline.py's quarter-DSEC tree and tuning."""
    kill_resume(tmp_path, (240, 320), 150_000, 49152,
                ["solver.n_pyr_lvls=5", "solver.theta_maxiter=8", "solver.theta_miniter=4",
                 "solver.handover_maxiter=5", "solver.max_ls_evals=4"])
