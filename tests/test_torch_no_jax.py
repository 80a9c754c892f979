"""eincm_tpu_torch (every module, parallel/ and the examples included)
runs where JAX and PyYAML are not installed, as on the GPU machine, and
imports matplotlib, PIL, imageio and h5py (which that machine lacks too)
only inside the functions that use them, or not at all, and never
zstandard;
the shipped configs load there, and the DSEC, MVSEC and ECD loaders read a
tree each (written here by tests/dataset_fixtures.py, with h5py, PIL and
PyYAML) and stage one window; the CLI on configs/synthetic.yaml (plot:
true) raises before staging a window, naming phases.plot. chip_smoke.py refuses to report without a
CUDA device."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
# the card's machine has none of these: the port imports them in the
# functions that use them
sys.modules["matplotlib"] = None
sys.modules["PIL"] = None
sys.modules["h5py"] = None
sys.modules["imageio"] = None
sys.modules["zstandard"] = None  # the port decodes Zstd itself (native/zstd.cpp)
import importlib, pkgutil
import eincm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eincm_tpu_torch.__path__, "eincm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# among them the window mesh's modules, the examples, the benchmark
# functions, the studies, the Blosc decoder and the HDF5 reader
assert {"eincm_tpu_torch.parallel", "eincm_tpu_torch.parallel.batch",
        "eincm_tpu_torch.parallel.distributed", "eincm_tpu_torch.examples.synthetic_recovery",
        "eincm_tpu_torch.examples.sequence_sharding", "eincm_tpu_torch.utils.benchmarks",
        "eincm_tpu_torch.utils.blosc", "eincm_tpu_torch.native.blosc",
        "eincm_tpu_torch.utils.h5_lite", "eincm_tpu_torch.utils.h5_latest",
        "eincm_tpu_torch.scripts"} | {
        "eincm_tpu_torch.scripts." + s for s in (
            "ls_evals_ab", "ftol_ab", "mvsec_loss_breakdown", "edge_sensitivity",
            "armijo_interp_probe", "hessian_warmstart_probe", "armijo_rescue_validation")
        } <= set(names), names
import torch
from eincm_tpu_torch.models.loss import (
    LossParams, LossStatics, compute_window_statics, solver_loss)
g = torch.Generator().manual_seed(0)
xs = torch.randint(0, 32, (500,), generator=g).float()
ys = torch.randint(0, 24, (500,), generator=g).float()
ts = torch.rand(500, generator=g)
edges = torch.rand(2, 24, 32, generator=g)
edge_ts = torch.tensor([0.0, 1.0])
ws = compute_window_statics(xs, ys, edges, (24, 32))
theta = torch.zeros(4, 4, 2, requires_grad=True)
loss = solver_loss(theta, xs, ys, ts, edges, edge_ts, LossParams(20.0, 35.0),
                   0, LossStatics((24, 32), 3), ws)
loss.backward()
assert torch.isfinite(loss) and torch.isfinite(theta.grad).all()
# the shipped configs load without PyYAML
import pathlib
from eincm_tpu_torch.experiments.config import load_config
configs = sorted(pathlib.Path("configs").glob("*.yaml"))
assert len(configs) == 5
for path in configs:
    load_config(str(path)).solver_config()
# the real-data loaders: one tree each, through the config, one window staged
from eincm_tpu_torch.data.staging import stage_datasample
from eincm_tpu_torch.experiments.config import DatasetConfig
trees = pathlib.Path(sys.argv[1])
for kw in (dict(kind="dsec", root_dir=str(trees / "dsec"), sequence_name="mini_seq",
                data_split="train", sensor_size=(120, 160), des_n_events=4000),
           dict(kind="mvsec", root_dir=str(trees / "mvsec"), sequence_name="outdoor_day2",
                des_n_events=2000),
           dict(kind="ecd", root_dir=str(trees / "ecd"), sequence_name="slider_mini",
                des_n_events=500)):
    loader = DatasetConfig(**kw).make_loader()
    loader.get_ready()
    staged = stage_datasample(loader[0], "cpu")
    assert 0 < staged.window.xs.shape[0] <= kw["des_n_events"], kw
    assert torch.isfinite(staged.window.edges).all()
# phases.plot with matplotlib blocked: the CLI raises before staging a window
from eincm_tpu_torch.experiments.__main__ import main
from eincm_tpu_torch.experiments.manager import EINCMExperiment
EINCMExperiment.stage = lambda self, ds: sys.exit("a window was staged")
try:
    main(["--device", "cpu", "--config", "configs/synthetic.yaml",
          "output_dir=" + str(trees / "out"), "dataset.n_windows=2"])
    raise SystemExit("phases.plot=true ran without matplotlib")
except ImportError as e:
    assert "phases.plot=true draws with matplotlib" in str(e), e
    assert "set phases.plot=false" in str(e), e
assert not any(m == "jax" or m.startswith(("jax.", "eincm_tpu.", "matplotlib", "PIL", "h5py",
                                            "imageio", "yaml"))
               for m in sys.modules if sys.modules[m] is not None)
print("imported", len(names), "modules; loaded", len(configs), "configs and 3 trees")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # several test workers share the machine
    return env


def test_port_imports_and_runs_without_jax_or_yaml(tmp_path):
    from dataset_fixtures import make_dsec_tree, make_ecd_tree, make_mvsec_tree

    make_dsec_tree(tmp_path / "dsec", sensor=(120, 160), n_ev=20000, geometry="warped")
    make_mvsec_tree(tmp_path / "mvsec", gt_margin=0.05)
    make_ecd_tree(tmp_path / "ecd")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path)], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_chip_smoke_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
