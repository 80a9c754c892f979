"""The check that decides `correct`: the timed path's answers against the
plain reference (`reference.py`).

For each window of the sample, what the timed solve produced is judged:
- at every pyramid level, the loss value and gradient that BFGS ended on
  (`SolveResult.theta_opt_states[level]`: `fun_val`, `grad` at `x`, each
  computed inside the window by the port's kernels), against the
  reference's float64 loss and gradient at the same theta:
  `loss_rel` = |f - f_ref| / |f_ref|, and `grad_rel` = |g - g_ref| /
  |g_ref| (Euclidean norms) over all the window's levels at once (a
  converged level's gradient is near zero, so each level's own scale
  would measure rounding against nothing);
- the window's answer, its flow at the sensor (the port's upscale of the
  final level-0 theta, made in the timed loop), against the reference's
  upscale of the same theta: `flow_px`, the largest gap in pixels;
- where the configuration sets gamma (the event-masked TV term, added at
  level 0 only), the loss and gradient gaps against the TV term itself,
  each the largest over the sample: `tv_rel` = |f - f_ref| /
  |gamma TV_ref| at every level (TV_ref of that level's theta, whether or
  not the term belongs there), and `tv_grad_rel` = |g - g_ref| /
  |gamma grad TV_ref| at level 0. The term is ~3e-3 of the loss and its
  gradient 2-8% of the data terms', inside `loss_rel`'s and `grad_rel`'s
  limits, so a program that left it out, or kept its value but not its
  gradient, or added it above level 0, would pass those: each reads ~1
  in one of these two. A window whose term is 0 gives no reading, and a
  number with no reading reads inf.
Beside these, `run.py` compares `aee_max`, the largest AEE of any window
the run completed against the generator's exact velocity, which holds
the solve to its answer: the three above judge the loss and flow at
whatever theta BFGS ended on, and a solve that stopped at its prior would
pass them.
The control puts the reference in the program's place in bfloat16, the
precision below the float32 that the configuration runs, and reads the
same numbers (`benchmark/readings.py` and the tests run it and judge it
through `run.assemble`; a benchmark run does not).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark import reference

NUMBERS = ("loss_rel", "grad_rel", "flow_px")
TV_NUMBERS = ("tv_rel", "tv_grad_rel")  # compared only where gamma != 0


def finite_max(values) -> float:
    out = 0.0
    for v in values:
        v = float(v)
        if not math.isfinite(v):
            return math.inf
        out = max(out, v)
    return out


class Checker:
    def __init__(self, config: Dict, raw: List[Dict], device):
        exp = config["experiment"]
        if exp.get("delta", 0.0):
            raise NotImplementedError("the reference has no IWE divergence term (delta)")
        if exp.get("solver", {}).get("scale_theta_to_sensor_size_method", "bilinear") != "bilinear":
            raise NotImplementedError("the reference upscales bilinearly")
        self.alpha, self.beta = float(exp["alpha"]), float(exp["beta"])
        self.gamma = float(exp.get("gamma", 0.0))
        self.numbers = NUMBERS + (TV_NUMBERS if self.gamma else ())
        self.edge_cfg = exp["edge"]
        self.sensor = tuple(int(s) for s in exp["dataset"]["sensor_size"])
        self.raw = raw
        self.device = device
        self._windows: Dict = {}
        self._masks: Dict = {}

    def window(self, k: int, dtype=torch.float64) -> reference.RefWindow:
        if (k, dtype) not in self._windows:
            edges = self._windows[(k, torch.float64)].edges_np if dtype != torch.float64 else None
            self._windows[(k, dtype)] = reference.RefWindow(
                self.raw[k], self.edge_cfg, self.sensor, self.device, dtype, edges,
                self.mask(k))
        return self._windows[(k, dtype)]

    def mask(self, k: int) -> torch.Tensor:
        """Window k's pixels with events, made once for the AEE of every
        window the run completed and for the sample's reference windows."""
        if k not in self._masks:
            self._masks[k] = reference.event_mask(self.raw[k], self.sensor, self.device)
        return self._masks[k]

    def aee(self, k: int, theta0: torch.Tensor, vel) -> float:
        return reference.aee(theta0, vel, self.mask(k), self.sensor)

    def check(self, items, control: bool = False, program_edges=None) -> Dict:
        """`items`: (window k, BFGS states, level shapes, final level-0
        theta, flow) of each window of the sample."""
        got: Dict[str, List[float]] = {n: [] for n in self.numbers}
        ctl: Dict[str, List[float]] = {n: [] for n in self.numbers}
        edges = []
        for k, states, shapes, theta0, flow in items:
            ref = self.window(k)
            low = self.window(k, torch.bfloat16) if control else None
            self._levels(ref, states, shapes, got)
            fr = reference.upscale(theta0.detach().to(torch.float64), self.sensor)
            got["flow_px"].append((flow.to(torch.float64) - fr).abs().max())
            if control:
                self._levels(ref, states, shapes, ctl, low)
                fl = reference.upscale(theta0.detach().to(torch.bfloat16), self.sensor)
                ctl["flow_px"].append((fl.to(torch.float64) - fr).abs().max())
            if program_edges is not None:
                edges.append(float((program_edges[k].to(torch.float64)
                                    - ref.edges).abs().max()))
        out = _maxima(got)
        out["windows"] = len(items)
        out["levels"] = sum(len(it[1]) for it in items)
        if edges:
            out["edges_max"] = max(edges)
        if control:
            out["control"] = _maxima(ctl)
        return out

    def _levels(self, ref, states, shapes, into, low=None) -> None:
        """loss_rel of each level, grad_rel of the window and, where
        gamma != 0, tv_rel of each level and tv_grad_rel of level 0, of
        the program's values or (with `low`) of the reference in `low`'s
        precision, at the thetas BFGS ended on (`states[0]` the finest
        level)."""
        d2, r2 = 0.0, 0.0
        for level, (st, shape) in enumerate(zip(states, shapes)):
            theta = st.x.detach().reshape(shape)
            f_ref, g_ref = ref.loss_and_grad(theta, self.alpha, self.beta)
            if self.gamma:
                tv, g_tv = ref.tv_and_grad(theta)
                weight = reference.tv_weight(self.gamma, level)
                if weight != 0.0:
                    f_ref, g_ref = f_ref + weight * tv, g_ref + weight * g_tv
            if low is None:
                f, g = st.fun_val, st.grad
            else:
                f, g = low.loss_and_grad(theta, self.alpha, self.beta, self.gamma, level)
            f = f.to(torch.float64).reshape(())
            g = g.to(torch.float64).reshape(-1)
            into["loss_rel"].append((f - f_ref).abs() / f_ref.abs())
            gap2 = float(((g - g_ref.reshape(-1)) ** 2).sum())
            d2 += gap2
            r2 += float((g_ref ** 2).sum())
            if self.gamma:
                term = abs(self.gamma * float(tv))
                if term > 0:
                    into["tv_rel"].append(float((f - f_ref).abs()) / term)
                term_g = abs(self.gamma) * float(torch.linalg.norm(g_tv))
                if level == 0 and term_g > 0:
                    into["tv_grad_rel"].append(math.sqrt(gap2) / term_g)
        into["grad_rel"].append(math.sqrt(d2 / r2) if r2 > 0 else math.inf)


def _maxima(readings: Dict[str, List[float]]) -> Dict:
    """Each number's largest reading; inf where no window of the sample
    gave one."""
    return {n: finite_max(v) if v else math.inf for n, v in readings.items()}
