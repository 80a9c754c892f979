"""The port's experiment shell (eincm_tpu_torch/experiments/) against the
JAX package's (eincm_tpu/experiments/), on the CPU.

The same configuration (tests/test_experiment.py's `tiny_cfg` size:
32x32, 1024 events, 3 windows, 3 levels) runs through both managers; the
port is given `device="cpu"`. A first window's per-level iterations and
statuses must be equal and its losses agree to float32 rounding (the JAX
package row-sorts its events for the banded splat, so sums run in another
order); chained windows are held by mean AEE within 0.05 px (ROADMAP.md,
"held against the reference"). Each package reads the other's npz files.
"""

import dataclasses
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import eincm_tpu.experiments.config as jcfg
import eincm_tpu.native.vision as jax_native
import eincm_tpu_torch.native.vision as port_native
from eincm_tpu.experiments.manager import EINCMExperiment as JaxExperiment
from eincm_tpu.experiments.outputs import EINCMOutputLoader as JaxOutputLoader
from eincm_tpu.experiments.outputs import validate_eval_results as jax_validate_eval
from eincm_tpu.experiments.outputs import validate_opt_results as jax_validate_opt
from eincm_tpu_torch.experiments import config as tcfg
from eincm_tpu_torch.experiments.manager import EINCMExperiment
from eincm_tpu_torch.experiments.outputs import (
    EINCMOutputLoader,
    solve_result_to_record,
    validate_eval_results,
    validate_opt_results,
)
from eincm_tpu_torch.utils import host, yaml_lite

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
CPU = torch.device("cpu")
TOL_FUN = 1e-5  # relative, first window's per-level losses (float32)
TOL_AEE = 0.05  # px, mean over windows
TOL_EVAL = 1e-4  # relative, the same solve evaluated by both packages


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny experiments gain nothing from threads, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(mod, tmp_path, **kw):
    """tests/test_experiment.py's tiny_cfg for either package's config."""
    cfg = mod.ExperimentConfig()
    cfg.dataset.kind = "synthetic"
    cfg.dataset.sensor_size = (32, 32)
    cfg.dataset.des_n_events = 1024
    cfg.dataset.n_windows = 3
    cfg.dataset.velocity = (2.0, -1.0)
    cfg.solver.n_pyr_lvls = 3
    cfg.solver.theta_maxiter = 6
    cfg.solver.theta_miniter = 3
    cfg.solver.handover_maxiter = 5
    cfg.solver.max_ls_evals = 6
    cfg.alpha, cfg.beta = 60.0, 0.0
    cfg.edge.enable_image_preprocessing = False
    cfg.output_dir = str(tmp_path)
    cfg.phases.plot = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def port_exp(tmp_path, **kw):
    return EINCMExperiment(tiny_cfg(tcfg, tmp_path, **kw), device=CPU)


def _aees(eval_results):
    return [float(np.asarray(r["evals"]["AEE"])) for r in eval_results.values()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port experiment on the same configuration, then a
    JAX EVAL of the port's opt_results.npz. Both keep their checkpoints
    (one after each window): the port resumes from the JAX package's."""
    jax_exp = JaxExperiment(tiny_cfg(jcfg, tmp_path_factory.mktemp("jax")))
    jax_exp.cfg.phases.delete_checkpoints_at_end = False
    jax_exp.run()
    port = EINCMExperiment(tiny_cfg(tcfg, tmp_path_factory.mktemp("port")), device=CPU)
    port.cfg.phases.delete_checkpoints_at_end = False
    port.run()
    cross = JaxExperiment(tiny_cfg(jcfg, tmp_path_factory.mktemp("cross")))
    cross.run_eval(str(port.out_dir / "opt_results.npz"))
    return jax_exp, port, cross


# ---- the YAML-free loader ----------------------------------------------------

def _same(a, b):
    """Equal values of equal types, NaN equal to NaN, recursively."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(
            type(k) is type(kb) and _same(a[k], b[k]) for k, kb in zip(a, b)
        )
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_reader_matches_safe_load(path):
    text = path.read_text()
    assert _same(yaml_lite.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_load_config_matches_jax(path):
    got, ref = tcfg.load_config(str(path)), jcfg.load_config(str(path))
    assert _same(got.to_dict(), ref.to_dict())
    # the SolverConfig bridge: the same budgets, tolerances and switches
    sg, sr = got.solver_config(), ref.solver_config()
    for name in ("n_pyr_lvls", "sensor_size", "theta_opt_maxiters", "handover_opt_maxiters",
                 "theta_gtol", "n_extra_attempts", "pyramid_bases", "max_ls_evals",
                 "line_search", "theta_ftol", "theta_ftol_patience", "collect_intermediate"):
        assert getattr(sg, name) == getattr(sr, name), name
    assert dataclasses.asdict(sg.params) == dataclasses.asdict(sr.params)
    assert dataclasses.asdict(sg.handover) == dataclasses.asdict(sr.handover)


OVERRIDE_VALUES = [
    "1e-5", "1.0e-5", "3.0e5", "-1e-3", "1e5", "on", "off", "yes", "no", "Yes",
    "OFF", "true", "False", "null", "~", "Null", "", "[1, 2]", "{0: 1}",
    "{0: 2, 1: 2, 2: 2}", "[a, [1, 2.5], {x: y}]", "abc", "abc def", "/tmp/out dir",
    "42", "-3", "+4", "0", "007", "0x1f", "0b101", "1_000", "1:30", ".5", "1.",
    ".inf", "-.inf", ".nan", "'quoted'", '"dq"', "it's", "a#b", "http://x:80/y",
    "2.5.3", "[1, 2", "@x", "a: b",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_override_value_parses_as_jax(raw):
    assert _same(tcfg._parse_value(raw), jcfg._parse_value(raw))


UNSUPPORTED = [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  text", "a: >\n  text", "- &a 1",
    "- 1\n  - 2", "---\na: 1", "a: 1\n---\nb: 2", "a: 2001-12-14", "<<: {a: 1}",
    "a: [1,\n  2]", "a: b\n  c", "%YAML 1.1\na: 1",
]


BLOCK_SEQUENCES = [
    "- 1\n- 2", "a:\n  - 1\n  - x y", "a:\n- 1\n- 2\nb: on",
    "R:\n- - 0.99  # c\n  - -0.01\n- - 1.0e-05\n  - 2\nT: [1, 2]",
    "- - - 1\n    - 2\n  - 3\n- 4", "-\n  k: v\n- \n- x: 1\n  y:\n  - 2\n  z: null",
    "a:\n  b:\n  - {c: 1}\n  - [d, e]\n  - 'q: r'\nf: 1",
]


@pytest.mark.parametrize("text", BLOCK_SEQUENCES)
def test_block_sequences_match_pyyaml(text):
    assert _same(yaml_lite.loads(text), yaml.safe_load(text))


def test_cam_to_cam_matches_pyyaml(tmp_path):
    """DSEC's calibration as `yaml.safe_dump` writes it (block sequences),
    as tests/dataset_fixtures.py writes it, and as the port's tree writer
    does."""
    from dataset_fixtures import make_dsec_tree

    from eincm_tpu_torch.utils import dataset_trees

    root, seq = make_dsec_tree(tmp_path / "a", geometry="warped", sensor=(12, 16), n_ev=100)
    tree = dataset_trees.write_dsec_tree(tmp_path / "b", sensor=(24, 32), n_windows=1,
                                         events_per_window=50, n_features=2)
    for path in (root / f"Train/train_calibration/{seq}/calibration/cam_to_cam.yaml",
                 tree["root"] / f"Train/train_calibration/{tree['sequence']}/calibration"
                 / "cam_to_cam.yaml"):
        with open(path) as f:
            ref = yaml.safe_load(f)
        assert _same(yaml_lite.load(path), ref)
        assert isinstance(ref["extrinsics"]["T_10"][0], list)


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_unsupported_yaml_raises(text):
    with pytest.raises(yaml_lite.UnsupportedYAML, match="line"):
        yaml_lite.loads(text)


@pytest.mark.parametrize("text", ["\ta: 1", "a: [1, 2", "a: b: c", "a: @x", "a: 1\n b: 2",
                                  "a: 1\nb"])
def test_malformed_yaml_raises(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(yaml_lite.YAMLSyntaxError, match="line"):
        yaml_lite.loads(text)


def test_overrides_match_jax():
    ovs = ["alpha=20", "dataset.des_n_events=999", "phases.plot=true",
           "solver.n_extra_attempts={0: 1, 1: 1}", "dataset.sensor_size=[24, 24]",
           "solver.theta_ftol=1e-6", "phases.run_idx_range=[1, 3]",
           "handover.solve_handover_for_levels=[0]", "solver.max_ls_evals=null"]
    got = tcfg.apply_overrides(tcfg.ExperimentConfig(), ovs)
    ref = jcfg.apply_overrides(jcfg.ExperimentConfig(), ovs)
    assert _same(got.to_dict(), ref.to_dict())
    assert tcfg.ExperimentConfig.from_dict(got.to_dict()).to_dict() == got.to_dict()
    with pytest.raises(KeyError):
        tcfg.apply_overrides(tcfg.ExperimentConfig(), ["nonexistent.key=1"])
    with pytest.raises(KeyError):
        tcfg.ExperimentConfig.from_dict({"dataset": {"nope": 1}})


# ---- the experiment against the JAX package's -------------------------------

def _tree(d):
    """Key structure of a record, with each leaf's dtype and shape."""
    if isinstance(d, dict):
        return {k: _tree(v) for k, v in d.items()}
    if isinstance(d, np.ndarray):
        return (d.dtype.str, d.shape)
    return type(d).__name__


def test_opt_results_schema_matches_jax(runs):
    jax_exp, port, _ = runs
    assert list(port.opt_results) == list(jax_exp.opt_results)
    for key in jax_exp.opt_results:
        assert _tree(port.opt_results[key]) == _tree(jax_exp.opt_results[key]), key
    assert set(port.eval_results) == set(jax_exp.eval_results)
    for key, rec in jax_exp.eval_results.items():
        assert _tree(port.eval_results[key]) == _tree(rec), key
    assert _same({**port.cfg.to_dict(), "output_dir": ""}, {**jax_exp.cfg.to_dict(), "output_dir": ""})


def test_first_window_matches_jax(runs):
    jax_exp, port, _ = runs
    ref = jax_exp.opt_results["datasample_idx_0"]["solver_final_results"]["theta_opt_state_pyr"]
    got = port.opt_results["datasample_idx_0"]["solver_final_results"]["theta_opt_state_pyr"]
    for lvl in ref:
        for key in ("iter_num", "total_iters", "n_attempts", "status"):
            assert int(got[lvl][key]) == int(ref[lvl][key]), (lvl, key)
        f_ref, f_got = float(ref[lvl]["fun_val"]), float(got[lvl]["fun_val"])
        assert abs(f_got - f_ref) <= TOL_FUN * abs(f_ref), (lvl, f_got, f_ref)


def test_mean_aee_matches_jax(runs):
    jax_exp, port, _ = runs
    got, ref = np.mean(_aees(port.eval_results)), np.mean(_aees(jax_exp.eval_results))
    assert abs(got - ref) <= TOL_AEE, (got, ref)
    assert got < 1.5  # zero flow scores |V| = 2.24 px


def test_scores_txt_matches_jax(runs):
    jax_exp, port, _ = runs
    names = lambda exp: re.findall(r"^(\w+):", (exp.out_dir / "scores.txt").read_text(), re.M)
    assert names(port) == names(jax_exp)
    assert "AEE" in names(port) and "fwl" in names(port)


def test_jax_reads_the_port_npz(runs):
    _, port, _ = runs
    loader = JaxOutputLoader()
    opt = loader.load_opt_results(port.out_dir / "opt_results.npz")
    jax_validate_opt(opt, 3)
    assert _same(loader.cfg, port.cfg.to_dict())
    jax_validate_eval(loader.load_eval_results(port.out_dir / "eval_results.npz"))


def test_port_reads_the_jax_npz(runs):
    jax_exp, _, _ = runs
    loader = EINCMOutputLoader()
    opt = loader.load_opt_results(jax_exp.out_dir / "opt_results.npz")
    validate_opt_results(opt, 3)
    validate_eval_results(loader.load_eval_results(jax_exp.out_dir / "eval_results.npz"))
    # and the port evaluates the JAX solve as the JAX package did
    exp = EINCMExperiment(tiny_cfg(tcfg, port_dir := jax_exp.out_dir.parent.parent / "port_of_jax"),
                          device=CPU)
    exp.run_eval(str(jax_exp.out_dir / "opt_results.npz"))
    for key, rec in jax_exp.eval_results.items():
        for m in ("AEE", "loss", "fwl"):
            ref, got = float(rec["evals"][m]), float(exp.eval_results[key]["evals"][m])
            assert abs(got - ref) <= TOL_EVAL * abs(ref), (key, m, got, ref)
    assert port_dir.exists()


def test_jax_eval_of_the_port_solve_matches(runs):
    _, port, cross = runs
    assert set(cross.eval_results) == set(port.eval_results)
    for key, rec in port.eval_results.items():
        ref = cross.eval_results[key]["evals"]
        for m, v in rec["evals"].items():
            if m in ("n_ee", "n_pred", "n_gt", "n_pixels"):
                assert int(v) == int(ref[m]), (key, m)
                continue
            np.testing.assert_allclose(np.asarray(v, np.float64), np.asarray(ref[m], np.float64),
                                       rtol=TOL_EVAL, atol=1e-6, err_msg=f"{key}/{m}")


@pytest.mark.parametrize("kind,extended", [("synthetic", False), ("dsec", True)])
def test_scores_match_jax(tmp_path, kind, extended):
    """extract_scores / write_scores against the JAX package's on the same
    eval_results, with DSEC-extended's original-timestamp subset."""
    import types

    rng = np.random.default_rng(3)
    evals = {f"datasample_idx_{i}": {"evals": {
        "AEE": np.float32(rng.uniform(0, 2)), "loss": np.float32(rng.normal()),
        "n_ee": np.int32(rng.integers(10, 99)), "rel_contrasts": rng.normal(size=2)}}
        for i in range(12)}
    texts = []
    for mod, cls in ((tcfg, EINCMExperiment), (jcfg, JaxExperiment)):
        cfg = mod.ExperimentConfig()
        cfg.dataset.kind, cfg.dataset.extended = kind, extended
        fake = types.SimpleNamespace(cfg=cfg, eval_results=evals, out_dir=tmp_path / mod.__name__)
        fake.out_dir.mkdir()
        scores = cls.extract_scores(fake)
        cls.write_scores(fake, scores)
        texts.append((scores, (fake.out_dir / "scores.txt").read_text()))
    (got, got_txt), (ref, ref_txt) = texts
    assert got == ref and got_txt == ref_txt
    assert ("orig_subset_mean" in got["AEE"]) == extended


# ---- the serial paths --------------------------------------------------------

def test_checkpoint_resume(tmp_path):
    exp = port_exp(tmp_path)
    exp.cfg.phases.checkpoint_every_percent = 33.0  # after every window
    exp.cfg.phases.delete_checkpoints_at_end = False
    exp.run_solver()
    ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
    assert [c.name for c in ckpts] == ["checkpoint_0_3.npz", "checkpoint_1_3.npz",
                                       "checkpoint_2_3.npz"]

    # resume from the first checkpoint: only the later windows are solved
    exp2 = port_exp(tmp_path / "resumed")
    exp2.cfg.phases.run_from_checkpoint = str(ckpts[0])
    solver, calls = exp2.window_solver, []
    exp2.window_solver = lambda *a, **k: (calls.append(a[1]), solver(*a, **k))[1]
    exp2.run_solver()
    ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
    assert len(exp2.opt_results) == 3 and len(calls) == 3 - len(ck) == 2
    # the first re-solved window starts from the checkpoint's last theta
    last = ck["datasample_idx_0"]["solver_final_results"]["final_theta_pyr"]
    for lvl, t in enumerate(calls[0]):
        np.testing.assert_array_equal(t.numpy(), last[f"pyr_lvl_{lvl}"])
    # the restored records are the checkpointed ones, bitwise
    for key, rec in ck.items():
        for group, levels in rec["solver_final_results"].items():
            for lvl, v in levels.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(
                        exp2.opt_results[key]["solver_final_results"][group][lvl], v)


@pytest.mark.parametrize("pct", [0, 100])
def test_checkpoint_percent_off(tmp_path, pct):
    exp = port_exp(tmp_path)
    exp.cfg.phases.checkpoint_every_percent = pct
    exp.cfg.phases.delete_checkpoints_at_end = False
    exp.run_solver()
    assert not list(exp.ckpt_dir.glob("checkpoint_*.npz"))


def test_checkpoints_deleted_at_end(tmp_path):
    exp = port_exp(tmp_path)
    exp.run_solver()
    assert not list(exp.ckpt_dir.glob("checkpoint_*.npz"))


@pytest.mark.parametrize("phases,keys", [
    ({"run_idx_ranges": ((0, 1), (2, 3))}, [0, 2]),
    ({"run_idx_range": (1, 3)}, [1, 2]),
])
def test_skip_ranges(tmp_path, phases, keys):
    exp = port_exp(tmp_path)
    for k, v in phases.items():
        setattr(exp.cfg.phases, k, v)
    exp.run_solver()
    assert sorted(exp.opt_results) == [f"datasample_idx_{i}" for i in keys]


def test_eval_only_invocation_loads_saved_artifacts(tmp_path):
    first = port_exp(tmp_path)
    first.run()
    exp = port_exp(tmp_path)
    exp.cfg.phases.solve = False
    exp.run()
    assert len(exp.eval_results) == 3
    assert (exp.out_dir / "scores.txt").read_text() == (first.out_dir / "scores.txt").read_text()


def test_eager_eval_in_solve_loop(tmp_path):
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = 4
    exp.cfg.phases.eager_eval = True
    exp.cfg.phases.eager_eval_every = 2  # windows 0 and 2
    exp.cfg.phases.eval = False
    exp.run_solver()
    assert set(exp.eval_results) == {"datasample_idx_0", "datasample_idx_2"}
    for aee in _aees(exp.eval_results):
        assert np.isfinite(aee)
    exp.run_eval()  # the EVAL phase still evaluates every window
    assert len(exp.eval_results) == 4


def test_eval_intermediate_hook(tmp_path):
    exp = port_exp(tmp_path)
    exp.cfg.phases.eval_intermediate = True
    exp.cfg.handover = dataclasses.replace(exp.cfg.handover, solve_handover_for_levels=(0,))
    exp = EINCMExperiment(exp.cfg, device=CPU)  # the solver collects histories
    exp.run_solver()
    rec = exp.opt_results["datasample_idx_1"]["solver_intermediate_results"]
    ho = rec["handover_opt"]
    assert int(ho["n_iters"]["pyr_lvl_0"]) > 0
    assert len(ho["weights"]["pyr_lvl_0"]) == int(ho["n_iters"]["pyr_lvl_0"])
    assert np.all(np.isfinite(ho["losses"]["pyr_lvl_0"]))
    exp.run_eval()
    inter = exp.eval_results["datasample_idx_0"]["intermediate"]
    thetas = exp.opt_results["datasample_idx_0"]["solver_intermediate_results"]["theta_opt"]
    assert len(inter["loss"]) == len(thetas["thetas"]["pyr_lvl_0"]) >= 1
    assert "AEE" in inter and np.all(np.isfinite(inter["AEE"]))
    assert inter["loss"].min() <= inter["loss"][0] + 1e-6


def test_record_is_one_host_transfer_and_syncs_are_counted(tmp_path, monkeypatch):
    """`solve_result_to_record` reads a whole SolveResult in one transfer,
    and each window's `stats` host syncs are every read the solve phase
    made (the solver's, the anomaly check's and the record's)."""
    calls = []
    real = host.to_host
    monkeypatch.setattr(host, "to_host", lambda t: (calls.append(1), real(t))[1])
    exp = port_exp(tmp_path)
    exp.cfg.solver.collect_intermediate = True
    exp = EINCMExperiment(exp.cfg, device=CPU)
    exp.run_solver()
    assert len(calls) == sum(s["host_syncs"] for s in exp.stats.values())
    dl = exp.cfg.dataset.make_loader()
    dl.get_ready()
    res = exp.window_solver(exp.stage(dl[0]).window, exp.solver_cfg.zero_pyramid(device=CPU), True)
    calls.clear()
    rec = solve_result_to_record(res)
    assert len(calls) == 1
    assert rec["solver_intermediate_results"]["theta_opt"]["thetas"]["pyr_lvl_0"].shape[0] == \
        res.theta_histories[0].n


class TestArmijoRescue:
    def test_anomaly_predicate(self):
        import types

        def fake(f_opt, status, f_prior):
            st = types.SimpleNamespace(fun_val=torch.tensor(f_opt), status=status)
            return types.SimpleNamespace(theta_opt_states=(st,),
                                         prior_loss_lvl0=torch.tensor(f_prior))

        anom = EINCMExperiment._anomalous
        assert not anom(fake(-5.0, 1, -4.0))  # improved on the prior
        assert not anom(fake(-5.0, 2, math.inf))  # first-ish window
        assert anom(fake(-3.0, 1, -4.0))  # worse than keeping the prior
        assert anom(fake(math.nan, 3, -4.0))  # NaN solve
        assert anom(fake(-5.0, 3, -4.0))  # status 3 alone

    def test_prior_loss_recorded(self, tmp_path):
        exp = port_exp(tmp_path)
        dl = exp.cfg.dataset.make_loader()
        dl.get_ready()
        staged = exp.stage(dl[0])
        res1 = exp.window_solver(staged.window, exp.solver_cfg.zero_pyramid(device=CPU), True)
        assert np.isposinf(float(res1.prior_loss_lvl0))
        res2 = exp.window_solver(staged.window, res1.final_theta_pyr, False)
        assert np.isfinite(float(res2.prior_loss_lvl0))
        assert not exp._anomalous(res2)

    def test_repeat_solve_keeps_first_prior_loss(self, tmp_path):
        exp = port_exp(tmp_path)
        exp.cfg.phases.n_repeat_solve = 2
        dl = exp.cfg.dataset.make_loader()
        dl.get_ready()
        staged0, staged1 = exp.stage(dl[0]), exp.stage(dl[1])
        res0 = exp._solve_one(exp.window_solver, staged0,
                              exp.solver_cfg.zero_pyramid(device=CPU), True)
        res1 = exp._solve_one(exp.window_solver, staged1, res0.final_theta_pyr, False)
        ref = exp.window_solver(staged1.window, res0.final_theta_pyr, False)
        f_repeat, f_ref = float(res1.prior_loss_lvl0), float(ref.prior_loss_lvl0)
        assert np.isfinite(f_repeat)
        np.testing.assert_allclose(f_repeat, f_ref, rtol=1e-6)
        f_self = float(exp.window_solver(staged1.window, ref.final_theta_pyr,
                                         False).prior_loss_lvl0)
        assert f_self < f_repeat
        # the repeats' host syncs add up
        assert res1.n_host_syncs > ref.n_host_syncs

    def test_rescue_engages_and_successor_starts_from_it(self, tmp_path, monkeypatch):
        """A forced anomaly on every non-first window: each is re-solved
        with strong Wolfe, and each successor's prior is the final theta
        the recorded (possibly rescued) window ended with: the JAX
        manager's chain."""
        exp = port_exp(tmp_path)
        exp.cfg.phases.eval = False
        monkeypatch.setattr(EINCMExperiment, "_anomalous", staticmethod(lambda res: True))
        priors = []
        solver = exp.window_solver
        exp.window_solver = lambda *a: (priors.append(a[1]), solver(*a))[1]
        exp.run_solver()
        assert exp.n_rescue_attempts == 2
        assert 0 <= exp.n_rescued <= exp.n_rescue_attempts
        assert exp._rescue_solver is not None
        validate_opt_results(exp.opt_results, 3)
        for i in (1, 2):
            prev = exp.opt_results[f"datasample_idx_{i - 1}"]["solver_final_results"]
            for lvl, t in enumerate(priors[i]):
                np.testing.assert_array_equal(t.numpy(), prev["final_theta_pyr"][f"pyr_lvl_{lvl}"])
        assert all(s["host_syncs"] > 0 for s in exp.stats.values())
        assert sum(s["rescued"] for s in exp.stats.values()) == exp.n_rescued

    def test_rescue_solver_is_strong_wolfe(self, tmp_path, monkeypatch):
        exp = port_exp(tmp_path)
        built = []
        import eincm_tpu_torch.experiments.manager as mgr

        real = mgr.make_window_solver
        monkeypatch.setattr(mgr, "make_window_solver",
                            lambda cfg, dev: (built.append(cfg), real(cfg, dev))[1])
        monkeypatch.setattr(EINCMExperiment, "_anomalous", staticmethod(lambda res: True))
        exp.cfg.phases.eval = False
        exp.run_solver()
        assert [(c.line_search, c.max_ls_evals, c.compute_prior_loss) for c in built] == [
            ("wolfe", 10, False)]

    def test_rescue_off_when_wolfe(self, tmp_path, monkeypatch):
        exp = port_exp(tmp_path)
        exp.cfg.phases.eval = False
        exp.cfg.solver.line_search = "wolfe"
        exp = EINCMExperiment(exp.cfg, device=CPU)
        monkeypatch.setattr(EINCMExperiment, "_anomalous", staticmethod(lambda res: True))
        exp.run_solver()
        assert exp.n_rescue_attempts == 0 and exp.n_rescued == 0


# ---- the CLI, the plots --------------------------------------------------------

CLI_ARGS = [
    "dataset.kind=synthetic", "dataset.sensor_size=[24, 24]", "dataset.des_n_events=256",
    "dataset.n_windows=2", "solver.n_pyr_lvls=2", "solver.theta_maxiter=3",
    "solver.theta_miniter=2", "solver.max_ls_evals=4", "alpha=30", "beta=0",
    "edge.enable_image_preprocessing=false", "phases.plot=false",
]


def test_cli_smoke(tmp_path):
    from eincm_tpu_torch.experiments.__main__ import main

    exp = main(["--device", "cpu", *CLI_ARGS, f"output_dir={tmp_path}"])
    assert exp.device == CPU
    assert (exp.out_dir / "opt_results.npz").exists()
    assert (exp.out_dir / "scores.txt").exists()


def test_cli_with_a_shipped_config(tmp_path):
    from eincm_tpu_torch.experiments.__main__ import main

    exp = main(["--device", "cpu", "--config", str(REPO / "configs" / "synthetic.yaml"),
                "dataset.sensor_size=[24, 24]", "dataset.des_n_events=256",
                "dataset.n_windows=2", "solver.theta_maxiter=3", "solver.theta_miniter=2",
                "phases.plot=false", f"output_dir={tmp_path}"])
    assert exp.cfg.experiment_name == "synthetic_smoke"
    assert len(exp.eval_results) == 2


def test_plot_phase(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = 2
    exp.cfg.phases.plot = True
    exp.cfg.solver.collect_intermediate = True
    exp.cfg.mpl_rcparams = {"figure.dpi": 72}
    exp = EINCMExperiment(exp.cfg, device=CPU)
    dpi0 = matplotlib.rcParams["figure.dpi"]
    try:
        exp.run()
        assert matplotlib.rcParams["figure.dpi"] == 72
    finally:
        matplotlib.rcParams["figure.dpi"] = dpi0
    plots = exp.out_dir / "plots"
    assert len(list(plots.glob("end_result_*.png"))) == 2
    assert (plots / "seq_aee.png").exists() and (plots / "end_results.gif").exists()
    assert len(list(plots.glob("step_result_*.png"))) >= 2
    assert list(plots.glob("handover_*_pyr0.png"))
    assert not (plots / "handover_000000_pyr0.png").exists()
    head = (plots / "end_results.avi").read_bytes()[:200]
    assert head[:4] == b"RIFF" and head[8:12] == b"AVI " and b"MJPG" in head


@pytest.mark.parametrize("setting", ["phases.plot", "phases.eager_plot"])
def test_plot_without_matplotlib_raises_before_staging(tmp_path, monkeypatch, setting):
    """configs/synthetic.yaml (plot: true) through the CLI and through
    EINCMExperiment.run where matplotlib does not import (the card's
    machine): ImportError naming the setting before any window is staged.
    Where matplotlib imports, the check passes and the run is unchanged."""
    from eincm_tpu_torch.experiments.__main__ import main
    from eincm_tpu_torch.experiments.manager import check_plotting

    overrides = [f"output_dir={tmp_path}", "dataset.sensor_size=[32, 32]",
                 "dataset.des_n_events=1024", "dataset.n_windows=2"]
    if setting == "phases.eager_plot":
        overrides += ["phases.plot=false", "phases.eager_plot=true"]
    cfg = tcfg.load_config(str(REPO / "configs/synthetic.yaml"), overrides)
    assert getattr(cfg.phases, setting.split(".")[1])
    staged = []
    monkeypatch.setattr(EINCMExperiment, "stage",
                        lambda self, ds: staged.append(ds) or pytest.fail("staged"))
    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401
    except ImportError:
        pass
    else:
        check_plotting(cfg)  # both import here: nothing happens
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=f"{setting}=true draws with matplotlib.*"
                                          f"set {setting}=false"):
        main(["--device", "cpu", "--config", str(REPO / "configs/synthetic.yaml"), *overrides])
    with pytest.raises(ImportError, match=f"set {setting}=false"):
        EINCMExperiment(cfg, device=CPU).run()
    assert staged == []


def test_eager_plot_and_plotter_extras(tmp_path, rng):
    pytest.importorskip("matplotlib")
    from eincm_tpu_torch.experiments.plotters import (
        EINCMExperimentPlotter,
        blend_image_events_and_gt_flow,
    )

    exp = port_exp(tmp_path)
    exp.cfg.phases.eager_plot = True
    exp.cfg.phases.eager_plot_every = 4  # window 0 only
    exp.cfg.phases.eval = False
    exp.run_solver()
    assert len(list((exp.out_dir / "plots").glob("**/*end_result*"))) == 1

    p = EINCMExperimentPlotter(exp.cfg, tmp_path / "extras")
    theta = rng.normal(0, 1, (16, 16, 2))
    assert p.plot_nan_theta(0, theta) is None
    theta[3, 4, 0] = np.nan
    assert p.plot_nan_theta(0, theta).exists()
    thetas = rng.normal(0, 1, (12, 2 * 8 * 8))
    assert p.plot_step_results(1, None, thetas, np.sort(rng.normal(0, 1, 12))[::-1]).exists()
    assert p.plot_grad_quiver(2, rng.normal(0, 1, (32, 32, 2)),
                              rng.normal(0, 1, (32, 32, 2))).exists()
    img = rng.uniform(0, 255, (24, 32))
    xs, ys = rng.uniform(0, 31, 200), rng.uniform(0, 23, 200)
    gt = rng.normal(0, 2, (24, 32, 2))
    pair = blend_image_events_and_gt_flow(img, xs, ys, gt)
    assert pair.shape == (24, 32, 3) and pair.dtype == np.uint8
    assert not np.array_equal(pair, blend_image_events_and_gt_flow(img, xs, ys, gt, True))


# ---- the parallel modes (tests/test_experiment.py:419-435, 480-570, 700-770) --

@pytest.mark.parametrize("mode,n_windows", [("two_pass", 4), ("sequence_shard", 6)])
def test_parallel_windows_mode(tmp_path, capsys, mode, n_windows):
    """Both schedules through the manager on a one-member mesh: valid
    artifacts, every window solved and evaluated, the JAX tests' AEE band;
    the note that checkpoint_every_percent is the serial path's."""
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = n_windows
    exp.cfg.phases.parallel_windows = True
    exp.cfg.phases.parallel_mode = mode
    exp.cfg.phases.checkpoint_every_percent = 10.0
    exp.run()
    assert "only applies to the serial path" in capsys.readouterr().out
    assert len(exp.opt_results) == n_windows
    validate_opt_results(exp.opt_results, exp.cfg.solver.n_pyr_lvls)
    validate_eval_results(EINCMOutputLoader().load_eval_results(exp.out_dir / "eval_results.npz"))
    assert np.mean(_aees(exp.eval_results)) < 1.6, _aees(exp.eval_results)
    passes = [exp.stats[i]["passes"] for i in range(n_windows)]
    # two_pass: window 0 keeps pass 1, the last window's pass 1 feeds no one
    assert passes == ([1] + [2] * (n_windows - 2) + [1] if mode == "two_pass"
                      else [1] * n_windows)
    assert not list(exp.ckpt_dir.glob("checkpoint_*.npz"))


def test_parallel_sequence_shard_is_the_serial_chain(tmp_path):
    """On one member, sequence_shard solves the exact chain: the serial
    path's records (without its armijo rescue, which the parallel path does
    not run), bitwise on the CPU."""
    serial = port_exp(tmp_path / "serial")
    serial.cfg.solver.armijo_rescue = False
    serial = EINCMExperiment(serial.cfg, device=CPU)
    serial.run_solver()
    par = port_exp(tmp_path / "parallel")
    par.cfg.phases.parallel_windows = True
    par.cfg.phases.parallel_mode = "sequence_shard"
    par.run_solver()
    for key, rec in serial.opt_results.items():
        for group, levels in rec["solver_final_results"].items():
            for lvl, v in levels.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(
                        par.opt_results[key]["solver_final_results"][group][lvl], v,
                        err_msg=f"{key} {group} {lvl}")


def test_parallel_eval_matches_serial(tmp_path):
    """5 windows in chunks of 4 (the last chunk one window): per-window
    metrics equal the serial EVAL's, with the same dtypes."""
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = 5
    exp.run_solver()
    exp.run_eval()
    serial = {k: r["evals"] for k, r in exp.eval_results.items()}
    exp.eval_results = {}
    exp.cfg.phases.parallel_eval = True
    exp.run_eval()
    assert set(exp.eval_results) == set(serial)
    for key, ref in serial.items():
        got = exp.eval_results[key]["evals"]
        assert set(got) == set(ref)
        for m, v in ref.items():
            assert np.asarray(got[m]).dtype == np.asarray(v).dtype, (key, m)
            np.testing.assert_allclose(np.asarray(got[m]), np.asarray(v), rtol=2e-5,
                                       atol=1e-6, err_msg=f"{key}/{m}")
    assert (exp.out_dir / "eval_results.npz").exists()
    assert (exp.out_dir / "scores.txt").exists()


def test_parallel_eval_pad_grows_beyond_des(tmp_path):
    """eval_events are not capped by des_n_events: the pad grows to the
    chunk's maximum (8192 + 100 events here) instead of raising."""
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = 2
    exp.run_solver()
    orig_stage = exp.stage
    big_n = 8192 + 100  # past the first 8192 bucket for des_n_events=1024

    def stage(sample):
        s = orig_stage(sample)
        ev = s.eval_events
        reps = -(-big_n // len(ev["x"]))
        return s._replace(eval_events={k: np.tile(np.asarray(v), reps)[:big_n]
                                       for k, v in ev.items()})

    exp.stage = stage
    exp.cfg.phases.parallel_eval = True
    exp.run_eval()
    assert len(exp.eval_results) == 2
    for aee in _aees(exp.eval_results):
        assert np.isfinite(aee)


def test_parallel_eval_rejects_mixed_gt(tmp_path):
    exp = port_exp(tmp_path)
    exp.cfg.dataset.n_windows = 2
    exp.run_solver()
    orig_stage = exp.stage
    exp.stage = lambda smp: (lambda s: s._replace(gt_flow=None) if s.eval_ts[0] > 0 else s)(
        orig_stage(smp))
    exp.cfg.phases.parallel_eval = True
    with pytest.raises(ValueError, match="mixes windows with and without"):
        exp.run_eval()


def _parallel_cfg(tmp_path, n_windows, **phases):
    cfg = tiny_cfg(tcfg, tmp_path)
    cfg.dataset.n_windows = n_windows
    cfg.dataset.velocity = (0.5, -0.25)  # 16-24 windows must fit the sensor
    cfg.phases.parallel_windows = True
    cfg.phases.eval = False
    for k, v in phases.items():
        setattr(cfg.phases, k, v)
    return cfg


def test_parallel_checkpoint_step_sized_from_solved_windows(tmp_path):
    """The super-step comes from the windows solved this run (16 of 24),
    not the loader's length: 50% is one checkpoint of 8 windows."""
    exp = EINCMExperiment(_parallel_cfg(
        tmp_path, 24, run_idx_range=(0, 16), parallel_checkpoint_every_percent=50.0,
        delete_checkpoints_at_end=False), device=CPU)
    exp.run_solver()
    assert len(exp.opt_results) == 16
    ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
    assert [c.name for c in ckpts] == ["checkpoint_7_24.npz"]
    assert len(np.load(ckpts[0], allow_pickle=True)["opt_results"].item()) == 8


@pytest.mark.parametrize("mode", ["sequence_shard", "two_pass"])
def test_parallel_windows_checkpoint_resume(tmp_path, mode):
    """Super-steps with the prior chain carried across them, a checkpoint
    after each; a run resumed from the first checkpoint solves only the
    second super-step's windows, from the checkpoint's last pyramid, and
    reproduces the straight run bitwise. The resumed run sizes its own
    super-steps from its 8 windows (50%: two of 4), so under two_pass
    window 12 starts from window 11's exact carry instead of its pass-1
    result: there the straight run is reproduced up to window 11; one-member
    sequence_shard is the exact chain whatever the super-steps."""
    exp = EINCMExperiment(_parallel_cfg(
        tmp_path, 16, parallel_checkpoint_every_percent=50.0, parallel_mode=mode,
        delete_checkpoints_at_end=False), device=CPU)
    exp.run_solver()
    assert len(exp.opt_results) == 16
    ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
    assert len(ckpts) == 1
    ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
    assert len(ck) == 8

    exp2 = EINCMExperiment(_parallel_cfg(
        tmp_path / "resumed", 16, parallel_checkpoint_every_percent=50.0, parallel_mode=mode,
        run_from_checkpoint=str(ckpts[0])), device=CPU)
    exp2.run_solver()
    assert sorted(i for i, st in exp2.stats.items() if "solve_ms" in st) == list(range(8, 16))
    same = 16 if mode == "sequence_shard" else 12
    for key, rec in list(exp.opt_results.items())[:same]:
        for group, levels in rec["solver_final_results"].items():
            for lvl, v in levels.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(
                        exp2.opt_results[key]["solver_final_results"][group][lvl], v,
                        err_msg=f"{key} {group} {lvl}")


@pytest.mark.parametrize("mode", ["two_pass", "sequence_shard"])
def test_jax_serial_checkpoint_resumed_by_port_parallel(runs, tmp_path, mode):
    """A checkpoint of the JAX package's serial manager (after window 0)
    resumed by the port's parallel path: its record restored bitwise, its
    last pyramid carried in as the boundary prior (window 1's prior)."""
    jax_exp, _, _ = runs
    ckpt = jax_exp.ckpt_dir / "checkpoint_0_3.npz"
    ck = np.load(ckpt, allow_pickle=True)["opt_results"].item()
    assert list(ck) == ["datasample_idx_0"]
    exp = port_exp(tmp_path)
    exp.cfg.phases.parallel_windows = True
    exp.cfg.phases.parallel_mode = mode
    exp.cfg.phases.eval = False
    exp.cfg.phases.run_from_checkpoint = str(ckpt)
    exp.run_solver()
    assert sorted(exp.opt_results) == [f"datasample_idx_{i}" for i in range(3)]
    assert sorted(i for i, st in exp.stats.items() if "solve_ms" in st) == [1, 2]
    last = ck["datasample_idx_0"]["solver_final_results"]
    for group, levels in last.items():
        for lvl, v in levels.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(
                    exp.opt_results["datasample_idx_0"]["solver_final_results"][group][lvl], v)
    prior = exp.opt_results["datasample_idx_1"]["solver_final_results"]["prior_theta_pyr"]
    np.testing.assert_array_equal(prior["pyr_lvl_0"], last["final_theta_pyr"]["pyr_lvl_0"])
    validate_opt_results(exp.opt_results, exp.cfg.solver.n_pyr_lvls)
    jax_validate_opt(EINCMOutputLoader().load_opt_results(exp.out_dir / "opt_results.npz"), 3)


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    """A rank other than 0 writes no file: no checkpoint directory, no npz,
    no scores."""
    import eincm_tpu_torch.experiments.manager as mgr

    monkeypatch.setattr(mgr, "process_rank", lambda: 1)
    exp = port_exp(tmp_path)
    exp.cfg.phases.parallel_windows = True
    exp.cfg.phases.parallel_eval = True
    exp.cfg.phases.parallel_checkpoint_every_percent = 50.0
    exp.run()
    assert len(exp.opt_results) == 3 and len(exp.eval_results) == 3
    assert not [p for p in tmp_path.rglob("*") if p.is_file()]


# ---- what the port does not run: it raises ------------------------------------

@pytest.mark.parametrize("kind", ["ecd", "mvsec", "dsec"])
def test_real_data_loaders_raise(kind):
    """The real-data loaders are ported: make_loader builds each with the
    JAX package's arguments (its attributes equal the JAX loader's); an
    unknown kind still raises."""
    kw = dict(kind=kind, root_dir="/data", sequence_name="indoor_flying1",
              des_n_events=1234, delta_idx=2, data_split="train", extended=True,
              load_more_images=True, use_new_pruning_limits=True,
              prefer_latest_events=False, sensor_size=(240, 320))
    got = vars(tcfg.DatasetConfig(**kw).make_loader())
    ref = vars(jcfg.DatasetConfig(**kw).make_loader())
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if key == "dataset":  # DSEC's path holder: compare its paths
            got[key], value = vars(got[key]), vars(value)
        assert str(got[key]) == str(value), key
    with pytest.raises(ValueError):
        tcfg.DatasetConfig(kind="nope").make_loader()


@pytest.mark.parametrize("override", [
    "distributed.local_device_ids=[0, 1]", "jax_config={jax_enable_x64: true}",
    "compilation_cache_dir=/tmp/cache",
])
def test_unrun_settings_raise(override):
    with pytest.raises(NotImplementedError):
        tcfg.load_config(None, [override])


@pytest.mark.parametrize("field,value", [
    ("distributed", tcfg.DistributedConfig(enable=True, local_device_ids=(0, 1))),
    ("jax_config", {"jax_enable_x64": True}),
    ("compilation_cache_dir", "/tmp/cache"),
])
def test_unrun_settings_raise_in_the_experiment(tmp_path, field, value):
    cfg = tiny_cfg(tcfg, tmp_path)
    setattr(cfg, field, value)
    with pytest.raises(NotImplementedError):
        EINCMExperiment(cfg, device=CPU)


def test_parallel_modes_raise(tmp_path):
    """The parallel modes run (above); what they cannot run raises: an
    unknown schedule, and windows without one fixed event count."""
    exp = port_exp(tmp_path)
    exp.cfg.phases.parallel_windows = True
    exp.cfg.phases.parallel_mode = "ring"
    with pytest.raises(ValueError, match="unknown parallel_mode 'ring'"):
        exp.run_solver()
    exp.cfg.phases.parallel_mode = "two_pass"
    exp.cfg.dataset.des_n_events = 0
    with pytest.raises(ValueError, match="requires dataset.des_n_events"):
        exp.run_solver()
    exp.cfg.phases.parallel_eval = True
    exp.opt_results = {"datasample_idx_0": {}}
    with pytest.raises(ValueError, match="requires dataset.des_n_events"):
        exp.run_eval()


def test_no_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EINCMExperiment(tiny_cfg(tcfg, tmp_path))
    from eincm_tpu_torch.experiments.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([*CLI_ARGS, f"output_dir={tmp_path}"])


class _Built(Exception):
    """Raised by a stub where the entry point would start its work."""


@pytest.mark.parametrize("entry", ["cli", "sequence_sharding"])
def test_a_bare_cuda_gets_an_index(monkeypatch, tmp_path, entry):
    """The entry points' default `--device cuda`, with no process group,
    reaches `torch.cuda.set_device` as cuda:0: torch refuses a CUDA device
    without an index there. CUDA and set_device are stubbed (this machine
    may have no card); the work stops where the experiment or the mesh
    would be built."""
    import eincm_tpu_torch.examples.sequence_sharding as ex
    from eincm_tpu_torch.experiments import __main__ as cli

    def set_device(device):
        device = torch.device(device)
        if device.index is None:
            raise ValueError("Expected a torch.device with a specified index")
        calls.append(device)

    def built(*args, device=None, **kw):
        raise _Built(device)

    calls = []
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(cli, "EINCMExperiment", built)
    monkeypatch.setattr(ex, "make_window_mesh", built)
    with pytest.raises(_Built) as info:
        if entry == "cli":
            cli.main(["--config", str(REPO / "configs/synthetic.yaml"),
                      f"output_dir={tmp_path}", "phases.parallel_windows=true"])
        else:
            ex.main([])
    assert calls == [torch.device("cuda", 0)]
    assert info.value.args[0] == torch.device("cuda", 0)


# ---- the chip_smoke.py [experiment] bound: the JAX package's reading ----------

CHIP_OVERRIDES = [
    "dataset.kind=synthetic", "dataset.n_windows=8", "dataset.velocity=[4.0, -3.0]",
    "phases.checkpoint_every_percent=25", "phases.delete_checkpoints_at_end=false",
    "phases.plot=false",
]


@pytest.mark.slow
@pytest.mark.parametrize("smoothen", ["eincm_iedt", "gaussian"])
def test_chip_experiment_reading(tmp_path, monkeypatch, smoothen):
    """`configs/mvsec_indoor.yaml` with chip_smoke.py's overrides (256x336,
    30k events, 8 windows, |V| = 5 px, preprocessing on), float32 on the
    CPU through both packages. With IEDT edges (chip_smoke.py's
    `edge.smoothen_method=eincm_iedt`) the JAX package's mean AEE over
    windows 1-7 plus TOL_AEE is chip_smoke.py's MAX_EXPERIMENT_AEE. With the
    config's default Gaussian edges the readings are printed only: on these
    dot scenes neither package recovers the flow. Both packages' C++
    filters are turned off: their numpy versions run."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    path = str(REPO / "configs" / "mvsec_indoor.yaml")
    ovs = [*CHIP_OVERRIDES, f"edge.smoothen_method={smoothen}"]
    jax_exp = JaxExperiment(jcfg.load_config(path, [*ovs, f"output_dir={tmp_path}/j"]))
    jax_exp.run()
    port = EINCMExperiment(tcfg.load_config(path, [*ovs, f"output_dir={tmp_path}/t"]), device=CPU)
    port.run()
    ref, got = _aees(jax_exp.eval_results), _aees(port.eval_results)
    print(f"\n[{smoothen}] AEE per window, JAX {np.round(ref, 4).tolist()}, port "
          f"{np.round(got, 4).tolist()}")
    print(f"[{smoothen}] mean AEE windows 1-7: JAX {np.mean(ref[1:]):.4f} px, port "
          f"{np.mean(got[1:]):.4f} px; rescue attempts / replaced: JAX "
          f"{jax_exp.n_rescue_attempts} / {jax_exp.n_rescued}, port "
          f"{port.n_rescue_attempts} / {port.n_rescued}")
    assert np.all(np.isfinite(ref)) and np.all(np.isfinite(got))
    if smoothen == "eincm_iedt":
        assert abs(np.mean(got[1:]) - np.mean(ref[1:])) <= TOL_AEE
        assert max(got) < 5.0 and max(ref) < 5.0  # zero flow: |V| = 5 px


def test_chip_smoke_runs_this_configuration():
    """chip_smoke.py's [experiment] phase runs the [eincm_iedt] case above,
    and its bound is that case's JAX reading plus TOL_AEE."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert sorted(cs.EXPERIMENT_OVERRIDES) == sorted(
        [*CHIP_OVERRIDES, "edge.smoothen_method=eincm_iedt"])
    assert cs.MAX_EXPERIMENT_AEE == pytest.approx(cs.EXPERIMENT_JAX_AEE + TOL_AEE)
    assert cs.EXPERIMENT_SPEED == pytest.approx(math.hypot(4.0, 3.0))
