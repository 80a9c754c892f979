"""The bounds of chip_smoke.py's real-data phases ([dsec], [mvsec], [ecd]):
the same trees (written by eincm_tpu_torch/utils/dataset_trees.py from the
same seeds), the same configs and overrides, run through the JAX package's
CLI on the CPU in float32 and scored as chip_smoke.py scores the card's
run. The JAX reading plus REAL_AEE_BAND is each phase's bound on the card.
The port's CLI runs the same experiment on the CPU where that fits a
session (MVSEC and ECD), and is held to the JAX reading by the band. The
[gaussian] cases print the JAX reading with each config's default Gaussian
edges beside the EINCM IEDT that chip_smoke.py uses (DSEC on 100k events a
window).

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_real_data.py -s
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from eincm_tpu.experiments import config as jcfg
from eincm_tpu.experiments.manager import EINCMExperiment as JaxExperiment
from eincm_tpu_torch.experiments import config as tcfg
from eincm_tpu_torch.experiments.manager import EINCMExperiment

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_are_set():
    """Every real-data phase has the JAX reading of its case, and the cases
    name shipped configs and tree writers that take their window counts."""
    cs = _chip_smoke()
    assert sorted(cs.REAL_CASES) == ["dsec", "ecd", "mvsec"]
    for tag, (config, overrides, n, jax_aee) in cs.REAL_CASES.items():
        assert (REPO / "configs" / config).exists()
        assert isinstance(jax_aee, float) and 0 < jax_aee < 1, tag
        assert n >= 3
    assert all(cs.IEDT in case[1] for case in cs.REAL_CASES.values())


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["mvsec", "ecd", "dsec"])
def test_chip_real_data_reading(tmp_path, tag):
    cs = _chip_smoke()
    config = str(REPO / "configs" / cs.REAL_CASES[tag][0])
    tree = cs.write_tree(tag, tmp_path / tag)
    # DSEC: windows 0-1 of the same tree (the JAX package's dense splat on
    # the CPU takes ~1 h a window at 1.5M events)
    n = 2 if tag == "dsec" else None
    jax_exp = JaxExperiment(jcfg.load_config(config, cs.real_args(tag, tree, tmp_path / "j", n)))
    jax_exp.run()
    aee, zero, mean = cs.score(jax_exp, tree, torch.device("cpu"))
    print(f"\n[{tag}] JAX: AEE per window {np.round(aee, 4).tolist()} (zero flow "
          f"{np.round(zero, 4).tolist()}); the bounded mean {mean:.4f} px; chip_smoke.py "
          f"has {cs.REAL_CASES[tag][3]}")
    assert all(a < z for a, z in zip(aee, zero))
    if tag != "dsec":  # 1.5M events a window: the plain versions take hours on a CPU
        port = EINCMExperiment(tcfg.load_config(config, cs.real_args(tag, tree, tmp_path / "t")),
                               device=torch.device("cpu"))
        port.run()
        got, _, got_mean = cs.score(port, tree, torch.device("cpu"))
        print(f"[{tag}] port: AEE per window {np.round(got, 4).tolist()}; the bounded mean "
              f"{got_mean:.4f} px")
        assert abs(got_mean - mean) <= cs.REAL_AEE_BAND
    assert round(mean, 4) == cs.REAL_CASES[tag][3]


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["mvsec", "ecd", "dsec"])
def test_gaussian_edges_reading(tmp_path, tag):
    """The configs' default Gaussian edges on the same scenes, printed
    beside the IEDT (for MVSEC and ECD: test_chip_real_data_reading's), as
    chip_smoke.py's choice of edges per phase rests on them."""
    cs = _chip_smoke()
    config = str(REPO / "configs" / cs.REAL_CASES[tag][0])
    if tag == "dsec":
        from eincm_tpu_torch.utils import dataset_trees

        tree = dataset_trees.write_dsec_tree(tmp_path / tag, n_windows=2,
                                             events_per_window=100_000)
        n, size = 2, ["dataset.des_n_events=100000"]
    else:
        tree, n, size = cs.write_tree(tag, tmp_path / tag), None, []
    means = {}
    for edges in ("eincm_iedt", "gaussian") if tag == "dsec" else ("gaussian",):
        args = [*cs.real_args(tag, tree, tmp_path / edges, n), *size,
                f"edge.smoothen_method={edges}"]
        exp = JaxExperiment(jcfg.load_config(config, args))
        exp.run()
        aee, zero, means[edges] = cs.score(exp, tree, torch.device("cpu"))
        print(f"\n[{tag}] JAX, {edges} edges: AEE per window {np.round(aee, 4).tolist()} "
              f"(zero flow {np.round(zero, 4).tolist()}); the bounded mean {means[edges]:.4f}")
        assert np.all(np.isfinite(aee))
