"""The check that decides `correct` fails when it should (CPU).

A tiny cell is run through the whole harness, chains in threads of this
process, with the timed path broken underneath: once for each fault the
cell can have (a solve that hands back its last state unchanged; half the
events left out of the loss, the mean taken over the rest; the window's
answer altered where it is made; a solve that stops at its prior), and
once with the control, the plain reference in bfloat16 put in the
program's place, whose result `run.assemble` has to judge not correct
under each cell's limits. One chip, so no exchange between chips can be
left out.
"""

from __future__ import annotations

import pytest

from benchmark import run, spec
from benchmark.test_bench_harness import tiny_run


def test_a_sound_run_is_correct():
    _, out = tiny_run()
    assert out["correct"] is True


def _stale_solver(monkeypatch):
    from eincm_tpu_torch.models import pyramid

    make = pyramid.make_window_solver

    def broken(cfg, device):
        solve, last = make(cfg, device), []

        def run(sample, prior, is_first):
            res = solve(sample, prior, is_first)
            out = last[0] if last else res
            last[:] = [res]
            return out  # the previous window's result, unchanged

        return run

    monkeypatch.setattr(pyramid, "make_window_solver", broken)


def _half_the_events(monkeypatch):
    from eincm_tpu_torch.models import loss

    splat = loss.splat_multi_ref
    monkeypatch.setattr(loss, "splat_multi_ref",
                        lambda wx, wy, sensor: 2.0 * splat(wx[:, ::2], wy[:, ::2], sensor))


def _answer_altered(monkeypatch):
    from eincm_tpu_torch.ops import resize

    scale = resize.scale_theta_to_sensor_size
    monkeypatch.setattr(resize, "scale_theta_to_sensor_size",
                        lambda theta, sensor, method: scale(theta, sensor, method) + 0.05)


def _prior_returned(monkeypatch):
    from eincm_tpu_torch.models import pyramid

    make = pyramid.make_window_solver

    def broken(cfg, device):
        solve = make(cfg, device)

        def run(sample, prior, is_first):
            res = solve(sample, prior, is_first)
            # the states and losses as solved, the answer the prior
            return res._replace(final_theta_pyr=tuple(prior))

        return run

    monkeypatch.setattr(pyramid, "make_window_solver", broken)


@pytest.mark.parametrize("fault", [_stale_solver, _half_the_events, _answer_altered,
                                   _prior_returned],
                         ids=["state_unchanged", "half_the_events", "answer_altered",
                              "prior_returned"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, out = tiny_run()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_prior_returned_fails_only_the_aee():
    r, out = tiny_run(control=True)
    assert out["correct"] is True
    for w in spec.benchmark()["workloads"]:
        r.cell.limits = spec.limits(w["name"])
        prior = run.assemble(r, False, judged="prior")
        assert prior["correct"] is False, w["name"]
        assert [n for n, c in prior["checks"].items() if c["value"] > c["limit"]] == ["aee_max"]


def test_the_control_is_not_correct_under_any_cells_limits():
    r, _ = tiny_run(control=True)
    for w in spec.benchmark()["workloads"]:
        r.cell.limits = spec.limits(w["name"])
        out = run.assemble(r, False, judged="control")
        assert out["correct"] is False, (w["name"], out["checks"])
        failed = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
        assert {"grad_rel", "flow_px"} <= failed, (w["name"], out["checks"])
    got, control = run.compared_numbers(r), run.compared_numbers(r, "control")
    assert all(got[n] < control[n] / 100 for n in ("loss_rel", "grad_rel", "flow_px")), \
        (got, control)
