"""CPU tests of the benchmark's harness: names, traffic, reference, result line.

    python -m pytest benchmark/ -q -p no:cacheprovider

The runs here use a tiny cell (48x64 sensor, 2000 events, 3 levels, two
chains) on the CPU, where the port takes its plain PyTorch kernels; a
test that needs the card is marked `gpu` and skips without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import chain, reference, run, spec, trace, traffic


def tiny_cell(chains: int = 2) -> spec.Cell:
    """The MVSEC tuning cut to a size the CPU runs in seconds."""
    cfg = spec.config("mvsec_indoor_flying1")
    cfg["experiment"]["dataset"].update(sensor_size=[48, 64], des_n_events=2000)
    cfg["experiment"]["solver"].update(n_pyr_lvls=3, theta_maxiter=8, theta_miniter=4)
    cfg["assumed"].update(n_features=30, speed_px=3.0)
    mix = dict(spec.mix("fleet7"), chains=chains, windows_per_chain=3, profile_seconds=0.5)
    bench = spec.benchmark()
    return spec.Cell("tiny", {"chips": 1}, cfg, mix, spec.limits("mvsec_fleet"),
                     bench["end_to_end"], bench["per_layer"])


def tiny_run(trace_on: bool = False, control: bool = False, seed: int = 2**31 + 11,
             launch=run.ChainThread):
    """One run of the tiny cell, its chains in threads of this process
    (so that a test can break the program underneath) unless `launch`
    says otherwise; a traced run takes processes, one profiler each."""
    import time

    cell = tiny_cell()
    r = run.run_cell(cell, seed, 1.5, trace_on, device="cpu", launch=launch,
                     control=control, t_start=time.perf_counter())
    return r, run.assemble(r, trace_on)


# ---- names -----------------------------------------------------------------

def test_every_cell_finds_its_config_mix_limits_and_readers_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.Cell.named(w["name"])
        assert cell.config["experiment"]["dataset"]["des_n_events"] > 0
        assert cell.mix["chains"] >= 1
        assert set(cell.limits["limits"]) == {"loss_rel", "grad_rel", "flow_px", "aee_max"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "windows_per_s"}
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert spec.config(c["name"])["source"] == c["source"]


def test_json_digit_keys_become_ints_as_yaml_reads_them():
    cfg = spec.config("dsec_zurich_city_12a")
    assert cfg["experiment"]["solver"]["n_extra_attempts"] == {0: 2, 1: 2, 2: 2, 3: 2, 4: 2}


# ---- traffic -----------------------------------------------------------------

def test_windows_are_deterministic_in_seed_chain_and_window():
    cfg = tiny_cell().config
    mix = tiny_cell().mix
    a = traffic.ChainPlan(mix, cfg, 7, 1).window(2)
    b = traffic.ChainPlan(mix, cfg, 7, 1).window(2)
    c = traffic.ChainPlan(mix, cfg, 7, 1).window(1)
    for k in ("x", "y", "t", "p"):
        assert np.array_equal(a["events"][k], b["events"][k])
    assert np.array_equal(a["images"], b["images"])
    assert not np.array_equal(a["events"]["x"], c["events"]["x"])
    assert len(a["events"]["x"]) == cfg["experiment"]["dataset"]["des_n_events"]


def test_a_seed_orders_the_same_walks():
    cell = tiny_cell(chains=4)
    plans = {s: [traffic.ChainPlan(cell.mix, cell.config, s, c) for c in range(4)]
             for s in (1, 2**40 + 5)}
    walks = {s: sorted((p.ladder, tuple(p.position(i) for i in range(12))) for p in ps)
             for s, ps in plans.items()}
    assert walks[1] == walks[2**40 + 5]
    assert [p.ladder for p in plans[1]] != [p.ladder for p in plans[2**40 + 5]]


@pytest.mark.parametrize("chain_no", [0, 3])
def test_every_prior_is_rotate_deg_from_its_window(chain_no):
    cell = tiny_cell(chains=4)
    plan = traffic.ChainPlan(cell.mix, cell.config, 99, chain_no)
    for step in range(1, 25):
        a = plan.velocity(plan.position(step - 1))
        b = plan.velocity(plan.position(step))
        ang = math.degrees(math.acos(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))))
        assert ang == pytest.approx(cell.mix["rotate_deg"], abs=1e-9)


def test_walk_goes_forward_and_back():
    assert [traffic.walk_position(s, 4) for s in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]


# ---- reference ---------------------------------------------------------------

def _one_event_window(x=3, y=2, t=0.5):
    return {"events": {"x": np.array([x], np.int16), "y": np.array([y], np.int16),
                       "t": np.array([t]), "p": np.array([True])},
            "images": np.zeros((2, 6, 7), np.uint8), "image_ts": np.array([0.0, 1.0]),
            "eval_ts": np.array([0.0, 1.0])}


def test_splat_is_the_3x3_gaussian_window_worked_by_hand():
    g0, g1 = 1 / math.sqrt(2 * math.pi), math.exp(-0.5) / math.sqrt(2 * math.pi)
    f = reference.splat(torch.tensor([[3.0]], dtype=torch.float64),
                        torch.tensor([[2.0]], dtype=torch.float64), (6, 7))[0]
    want = torch.zeros(6, 7, dtype=torch.float64)
    want[1:4, 2:5] = torch.tensor([[g1 * g1, g1 * g0, g1 * g1],
                                   [g0 * g1, g0 * g0, g0 * g1],
                                   [g1 * g1, g1 * g0, g1 * g1]], dtype=torch.float64)
    assert torch.allclose(f, want, rtol=0, atol=1e-15)
    # a corner event keeps only its on-sensor taps
    f = reference.splat(torch.tensor([[0.0]], dtype=torch.float64),
                        torch.tensor([[0.0]], dtype=torch.float64), (6, 7))[0]
    assert float(f.sum()) == pytest.approx((g0 + g1) ** 2, abs=1e-15)


def test_bilinear_upscale_worked_by_hand():
    theta = torch.tensor([[[1.0, 0.0]], [[3.0, 2.0]]], dtype=torch.float64)  # 2 x 1 cells
    flow = reference.upscale(theta, (4, 2))
    # rows of a 2-cell axis over 4 pixels sit at u = (i + 0.5) / 2 - 0.5
    assert flow[:, 0, 0].tolist() == [1.0, 1.5, 2.5, 3.0]
    assert flow[:, 1, 1].tolist() == [0.0, 0.5, 1.5, 2.0]


def test_loss_at_zero_flow_is_minus_half_of_alpha_plus_beta():
    # theta 0 warps nothing: each frame is the unwarped one, each relative
    # term is its frame's weight 1/2, and the loss -(alpha + beta) / 2
    ds = _one_event_window()
    ds["images"][:, 2, 3] = 255
    w = reference.RefWindow(ds, spec.config("mvsec_indoor_flying1")["experiment"]["edge"],
                            (6, 7), "cpu")
    f, g = w.loss_and_grad(torch.zeros(1, 1, 2), 20.0, 35.0)
    assert float(f) == pytest.approx(-27.5, abs=1e-12)
    assert torch.isfinite(g).all()


def test_reference_gradient_is_the_loss_slope():
    cell = tiny_cell()
    plan = traffic.ChainPlan(cell.mix, cell.config, 3, 0)
    w = reference.RefWindow(plan.window(1), cell.config["experiment"]["edge"], plan.sensor,
                            "cpu")
    theta = torch.tensor([[[1.0, -0.5], [0.7, 0.2]], [[0.4, 1.1], [-0.3, 0.8]]],
                         dtype=torch.float64)
    f, g = w.loss_and_grad(theta, 20.0, 35.0)
    d = torch.zeros_like(theta)
    d[1, 0, 1] = 1e-6
    fp, _ = w.loss_and_grad(theta + d, 20.0, 35.0)
    fm, _ = w.loss_and_grad(theta - d, 20.0, 35.0)
    assert float((fp - fm) / 2e-6) == pytest.approx(float(g[1, 0, 1]), rel=1e-4, abs=1e-6)


# ---- the run and its result line ---------------------------------------------

def test_result_line_has_the_contract_shape():
    r, out = tiny_run()
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"windows_per_s", "aee_px", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_result_line_has_busy_window_and_breakdown():
    r, out = tiny_run(trace_on=True, launch=run.ChainProcess)
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["window_s"] > 0
    bd = out["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in bd.values())
    names = set(out["metrics"])
    assert {"evals_per_window", "host_syncs_per_window"} <= names
    assert "interp_roofline" not in names  # nothing ran on a card to read


def test_cli_without_a_card_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "dsec_fleet", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_busy_union_counts_overlaps_once():
    a = [[0, 10], [20, 30]]
    b = [[5, 15], [40, 50]]
    assert trace.busy_s([a, b]) == pytest.approx(35e-9)
    assert trace.gaps(trace.merge(a + b), 60) == [(15, 20), (30, 40), (50, 60)]


# ---- what the port may not load ----------------------------------------------

def test_banned_names_are_compared_whole():
    sys.modules.setdefault("eincm_tpu_torch_probe_ok", type(sys)("eincm_tpu_torch_probe_ok"))
    assert "eincm_tpu_torch_probe_ok" not in chain.banned_modules()


def test_no_module_a_cell_imports_is_jax_or_the_jax_package():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import run, chain, compare, reference, readings, spec, trace, traffic\n"
        "from eincm_tpu_torch.data import staging\n"
        "from eincm_tpu_torch.experiments import config\n"
        "from eincm_tpu_torch.models import pyramid\n"
        "from eincm_tpu_torch.ops import resize, _build\n"
        "from eincm_tpu_torch.native import build\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "print(json.dumps(chain.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(spec.ROOT), check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.gpu
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in spec.benchmark()["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"],
                              "--seed", "12345", "--seconds", "5", "--trace", "0"],
                             capture_output=True, text=True, cwd=str(spec.ROOT), timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
