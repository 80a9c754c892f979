"""Experiment orchestration: SOLVE / EVAL / PLOT phases over a sequence.

Port of eincm_tpu/experiments/manager.py (reference: `EINCMExperiment`,
src/experiments/e00/exp_mgr.py:32-862): per-window staging overlapped with
the solves, the sequential prior-chain solve with the armijo rescue,
periodic checkpointing with resume, evaluation against ground truth, score
aggregation into scores.txt, and plotting. Everything runs on the device
the experiment is given (CUDA unless the caller asks for the CPU); nothing
falls back to the CPU.

The port's solve is driven from the host, so the JAX manager's one-window
readback lag (dispatch window i+1 before checking window i) buys nothing
here: each window is solved, checked, rescued if anomalous and recorded
before the next starts. The chain of solves and priors is the JAX
manager's: a rescued window's successor starts from the rescued prior.

The parallel modes (`phases.parallel_windows`, `phases.parallel_eval`)
run over the window mesh of `parallel/batch.py`: the ranks of the process
group (`distributed.enable`, one process per device), or this process
alone. Each rank stages only its own windows; every rank ends with every
window's records, and rank 0 alone writes files (opt_results.npz,
checkpoints, eval_results.npz, scores.txt, plots).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from eincm_tpu_torch.data.prefetch import StagingPrefetcher
from eincm_tpu_torch.data.staging import StagedSample, stage_datasample
from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, prepare_eval_inputs
from eincm_tpu_torch.experiments.config import ExperimentConfig
from eincm_tpu_torch.experiments.outputs import (
    EINCMOutputLoader,
    save_eval_results,
    save_opt_results,
    solve_result_to_record,
    validate_opt_results,
)
from eincm_tpu_torch.models.pyramid import make_window_solver
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.parallel.distributed import process_rank
from eincm_tpu_torch.utils import host
from eincm_tpu_torch.utils.console import log, ok, warn

# DSEC-extended scoring also reports the original-timestamp subset
# (exp_mgr.py:706-714): every 5th window, skipping the first.
_EXTENDED_SUBSET = slice(None, None, 5)

# the parallel EVAL pads each chunk's eval events to a multiple of this
_EVAL_PAD_BUCKET = 8192


def check_plotting(cfg: ExperimentConfig) -> None:
    """Raise before anything is solved when a PLOT setting asks for a
    library that does not import here (the card's machine has neither):
    `phases.plot` draws with matplotlib and assembles its video with PIL,
    `phases.eager_plot` draws with matplotlib. Where they import, nothing
    happens."""
    needs = [("phases.plot", ("matplotlib", "PIL")), ("phases.eager_plot", ("matplotlib",))]
    for setting, modules in needs:
        if not getattr(cfg.phases, setting.split(".")[1]):
            continue
        for module in modules:
            try:
                importlib.import_module(module)
            except ImportError as e:
                raise ImportError(
                    f"{setting}=true draws with {module}, which does not import here "
                    f"({e}); set {setting}=false"
                ) from e


def _n_evals(res) -> int:
    """The BFGS loss evaluations of a solve, over its levels."""
    return sum(s.n_fun_evals for s in res.theta_opt_states)


def _as_jax_dtypes(evals: Dict) -> Dict:
    """`evals` as numpy values of the JAX package's dtypes: the pixel
    counts the device computed are int64 tensors here and int32 arrays
    there (JAX without x64), so the npz schema stays one."""
    return {
        k: v.astype(np.int32) if isinstance(v, np.ndarray) and v.dtype == np.int64
        else np.asarray(v)
        for k, v in evals.items()
    }


class EINCMExperiment:
    """One experiment on `device` (CUDA by default; a CUDA device without
    CUDA raises). `stats[idx]` records each window's staging seconds, solve
    ms, host syncs, BFGS loss evaluations and rescue, and its EVAL ms."""

    def __init__(self, cfg: ExperimentConfig, device=torch.device("cuda")):
        cfg.check_runnable()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EINCMExperiment on {self.device}, but CUDA is not available "
                "(pass device='cpu' to run on the CPU)"
            )
        self.cfg = cfg
        self.solver_cfg = cfg.solver_config()
        self.edge_fn = cfg.edge.make_edge_fn()

        # armijo tail safeguard: the anomaly signal costs one extra
        # finest-level loss evaluation per window, so it is computed only
        # when the rescue is active
        self._rescue_on = (
            cfg.solver.line_search == "armijo" and cfg.solver.armijo_rescue
        )
        serial_cfg = self.solver_cfg
        if self._rescue_on:
            serial_cfg = dataclasses.replace(serial_cfg, compute_prior_loss=True)
        self.window_solver = make_window_solver(serial_cfg, self.device)

        self.out_dir = Path(cfg.output_dir) / cfg.experiment_name
        self.ckpt_dir = self.out_dir / "checkpoints"
        if self._writes:
            os.makedirs(self.ckpt_dir, exist_ok=True)

        self.opt_results: Dict = {}
        self.eval_results: Dict = {}
        self.stats: Dict[int, Dict] = {}
        self.dataloader = None
        self._prior_pyr = None
        self._is_first = True
        self._ckpt_idx = -1
        self._rescue_solver = None  # built on the first rescue
        self.n_rescue_attempts = 0  # anomalies that triggered a wolfe re-solve
        self.n_rescued = 0  # re-solves that actually replaced the result

    @property
    def _writes(self) -> bool:
        """Rank 0 of a process group (or the only process) writes files."""
        return process_rank() == 0

    # ------------------------------------------------------------------ prep

    def _prepare_dataloader(self):
        if self.dataloader is None:
            self.dataloader = self.cfg.dataset.make_loader()
            self.dataloader.get_ready()
        return self.dataloader

    def _maybe_resume(self):
        path = self.cfg.phases.run_from_checkpoint
        if not path:
            return
        log(f"resuming from checkpoint {path}")
        data = np.load(path, allow_pickle=True)
        self.opt_results = data["opt_results"].item()
        idxs = sorted(
            int(k.replace("datasample_idx_", "")) for k in self.opt_results
        )
        self._ckpt_idx = idxs[-1]
        last = self.opt_results[f"datasample_idx_{self._ckpt_idx}"]
        pyr = last["solver_final_results"]["final_theta_pyr"]
        self._prior_pyr = tuple(
            torch.as_tensor(pyr[f"pyr_lvl_{l}"], device=self.device)
            for l in range(self.solver_cfg.n_pyr_lvls)
        )
        self._is_first = False

    def _skip_idx(self, idx: int) -> bool:
        if idx <= self._ckpt_idx:
            return True
        rng = self.cfg.phases.run_idx_range
        if rng is not None and not (rng[0] <= idx < rng[1]):
            return True
        ranges = self.cfg.phases.run_idx_ranges
        if ranges is not None and not any(a <= idx < b for a, b in ranges):
            return True
        return False

    def stage(self, datasample) -> StagedSample:
        # NaN-pad every window to the configured event count (loaders can
        # come up short at sequence boundaries; padded events contribute
        # nothing)
        return stage_datasample(
            datasample,
            self.device,
            edge_fn=self.edge_fn,
            preprocess=self.cfg.edge.enable_image_preprocessing,
            pad_to=self.cfg.dataset.des_n_events,
        )

    def _prefetch(self, indices, stage_fn=None):
        """(idx, staged) over `indices`, staged ahead in worker threads
        (by `stage_fn`, default `self.stage`). A
        new thread's current stream is the device's default stream, not
        necessarily this thread's: the worker's host -> device copies go
        onto this thread's current stream, so the solve and the evaluation
        are ordered after them."""
        dl = self._prepare_dataloader()
        stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )

        def stage(ds):
            t0 = time.perf_counter()
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                staged = (stage_fn or self.stage)(ds)
            return staged, time.perf_counter() - t0

        for idx, (staged, stage_s) in StagingPrefetcher(dl, indices, stage, depth=2):
            self.stats.setdefault(idx, {})["stage_s"] = stage_s
            yield idx, staged

    # ----------------------------------------------------------------- solve

    def run_solver(self):
        if self.cfg.phases.parallel_windows:
            return self.run_solver_parallel()
        dl = self._prepare_dataloader()
        self._maybe_resume()
        if self._prior_pyr is None:
            self._prior_pyr = self.solver_cfg.zero_pyramid(device=self.device)

        n = len(dl)
        # 0 (or >= 100) disables mid-sequence checkpoints
        ckpt_pct = self.cfg.phases.checkpoint_every_percent
        ckpt_every = (
            max(1, int(np.ceil(n * ckpt_pct / 100.0)))
            if ckpt_pct and 0 < ckpt_pct < 100
            else None
        )
        t_begin = time.perf_counter()
        indices = [i for i in range(n) if not self._skip_idx(i)]
        for n_done, (idx, staged) in enumerate(self._prefetch(indices), 1):
            t0 = time.perf_counter()
            prior, first = self._prior_pyr, self._is_first
            res = self._solve_one(self.window_solver, staged, prior, first)
            syncs = res.n_host_syncs + 1  # + the record's transfer
            evals = _n_evals(res)
            rescued = False
            if self._rescue_on and not first:
                syncs += 1
                if self._anomalous(res):
                    fixed = self._rescue_window(idx, staged, prior, res)
                    syncs += self.stats[idx]["rescue_host_syncs"]
                    evals += self.stats[idx]["rescue_evals"]
                    rescued = fixed is not res
                    res = fixed
            self._prior_pyr = res.final_theta_pyr
            self._is_first = False
            rec = solve_result_to_record(res)
            self.opt_results[f"datasample_idx_{idx}"] = rec
            self.stats.setdefault(idx, {}).update(
                solve_ms=(time.perf_counter() - t0) * 1e3,
                host_syncs=syncs,
                evals=evals,
                rescued=rescued,
            )
            states = rec["solver_final_results"]["theta_opt_state_pyr"]
            f0 = float(states["pyr_lvl_0"]["fun_val"])
            iters = [int(states[f"pyr_lvl_{i}"]["iter_num"]) for i in range(len(states))]
            dt = time.perf_counter() - t_begin
            log(
                f"[{idx + 1}/{n}] solved (f={f0:.4f}, iters={iters}, "
                f"avg {dt / n_done:.1f}s/window)"
            )
            if ckpt_every and n_done % ckpt_every == 0:
                self.save_checkpoint(idx, n)
            self._eager_hooks(idx, staged)
        if self.n_rescue_attempts:
            warn(
                f"armijo rescue: {self.n_rescue_attempts}/{len(indices)} "
                f"windows re-solved with strong Wolfe, {self.n_rescued} "
                "replaced by the Wolfe result"
            )

        self._finish_solve(f"{len(self.opt_results)} windows")
        return self.opt_results

    def _finish_solve(self, what: str):
        validate_opt_results(self.opt_results, self.solver_cfg.n_pyr_lvls)
        if self._writes:
            save_opt_results(
                self.out_dir / "opt_results.npz", self.opt_results, self.cfg.to_dict()
            )
            ok(f"opt_results.npz saved ({what})")
        self._delete_checkpoints_if_configured()

    def _stream_sharded_batch(self, dl, indices, mesh):
        """Stage THIS rank's windows of `indices` through the prefetcher and
        stack them on its device (the ranks' windows are never staged
        here).

        The window count is padded to a multiple of the mesh size by
        repeating the last window (its results are discarded after the
        solve); rank r takes positions [r * per, (r + 1) * per) of the padded
        list. Every window is NaN-padded to `dataset.des_n_events` (padded
        events contribute nothing), so windows stack: a rank never sees the
        whole sequence, so it cannot discover a global maximum.

        Returns:
            (this rank's WindowSample batch, padded global batch size).
        """
        from eincm_tpu_torch.parallel.batch import stack_windows

        n = len(indices)
        batch_n = -(-n // mesh.size) * mesh.size
        per = batch_n // mesh.size
        padded = list(indices) + [indices[-1]] * (batch_n - n)
        mine = padded[mesh.rank * per : (mesh.rank + 1) * per]

        pad_to = self.cfg.dataset.des_n_events
        if not pad_to:
            raise ValueError(
                "parallel windows mode requires dataset.des_n_events: the "
                "streamed batch pads every window to that fixed event count "
                "(ragged windows cannot stack)"
            )

        def stage_padded(ds):
            actual = len(ds["events"]["x"])
            if actual > pad_to:
                raise ValueError(
                    f"window has {actual} events > des_n_events={pad_to}; "
                    "the loader must truncate to des_n_events in parallel "
                    "windows mode"
                )
            return self.stage(ds)

        # a repeated window is staged once
        staged = dict(self._prefetch(list(dict.fromkeys(mine)), stage_padded))
        return stack_windows([staged[i].window for i in mine]), batch_n

    def run_solver_parallel(self):
        """Whole-sequence solve over the window mesh (every rank of the
        process group, or this process alone).

        Two schedules for the sequential handover prior chain
        (src/eincm/solver.py:254-255):

        - 'two_pass' (default): pass 1 solves every window without a prior;
          pass 2 re-solves each with its predecessor's pass-1 result;
        - 'sequence_shard': contiguous chunks per rank with the exact
          in-chunk handover chain; chunk-boundary priors pass between
          neighbouring ranks (parallel.batch.sequence_shard_solve).

        No armijo rescue and no prior loss, as in the JAX package's parallel
        path.
        """
        from eincm_tpu_torch.parallel.batch import (
            make_window_mesh,
            result_at,
            sequence_shard_solve,
            two_pass_sequence_solve,
        )

        dl = self._prepare_dataloader()
        # checkpoint resume: restores solved records, skips their indices,
        # and carries the last solved window's final pyramid as the boundary
        # prior of the first remaining super-step (every rank reads it)
        self._maybe_resume()
        boundary = None if self._is_first else self._prior_pyr
        indices = [i for i in range(len(dl)) if not self._skip_idx(i)]
        mesh = make_window_mesh(device=self.device)
        n_dev, n = mesh.size, len(indices)

        mode = self.cfg.phases.parallel_mode
        if mode not in ("sequence_shard", "two_pass"):
            raise ValueError(f"unknown parallel_mode {mode!r}")
        solve = sequence_shard_solve if mode == "sequence_shard" else two_pass_sequence_solve

        # mid-sequence checkpoints (exp_mgr.py:511-519 for the parallel
        # path): super-steps of ~pct% of the windows, rounded up to a
        # multiple of the mesh size, the prior chain carried across them by
        # `boundary`, a checkpoint after each. A knob of its own: chunking
        # moves each super-step's first-window prior to the exact carry.
        pct = self.cfg.phases.parallel_checkpoint_every_percent
        if pct is None and self.cfg.phases.checkpoint_every_percent != 25.0:  # the default
            log(
                "NOTE: phases.checkpoint_every_percent is customized but "
                "only applies to the serial path; parallel runs checkpoint "
                "via phases.parallel_checkpoint_every_percent (unset: no "
                "mid-sequence checkpoints this run)"
            )
        total = len(dl)
        if pct and 0 < pct < 100 and n > n_dev:
            log(
                f"parallel super-step checkpointing every ~{pct}% of "
                "windows (prior chain carried exactly across super-steps)"
            )
            # sized from the n windows solved this run (resume or
            # run_idx_range can leave n << len(dl))
            step = max(n_dev, -(-int(np.ceil(n * pct / 100.0)) // n_dev) * n_dev)
        else:
            step = max(n, 1)

        t_begin = time.perf_counter()
        for start in range(0, n, step):
            chunk_idx = indices[start : start + step]
            batch, _ = self._stream_sharded_batch(dl, chunk_idx, mesh)
            window_stats: list = []
            res, _ = solve(
                self.solver_cfg, batch, mesh, boundary_prior=boundary,
                window_stats=window_stats,
            )
            del batch
            for rec in window_stats:  # this rank's solves; padded repeats dropped
                if rec["window"] < len(chunk_idx):
                    st = self.stats.setdefault(chunk_idx[rec["window"]], {})
                    st["solve_ms"] = st.get("solve_ms", 0.0) + rec["ms"]
                    st["passes"] = st.get("passes", 0) + 1
                    # + the record's transfer
                    st["host_syncs"] = st.get("host_syncs", 1) + rec["host_syncs"]
                    st["evals"] = st.get("evals", 0) + rec["evals"]
                    st["rescued"] = False
            for i, ds_idx in enumerate(chunk_idx):
                rec = solve_result_to_record(result_at(res, i))
                self.opt_results[f"datasample_idx_{ds_idx}"] = rec
                if self._writes:
                    states = rec["solver_final_results"]["theta_opt_state_pyr"]
                    iters = [int(states[f"pyr_lvl_{l}"]["iter_num"]) for l in range(len(states))]
                    log(
                        f"[{ds_idx + 1}/{total}] solved (f="
                        f"{float(states['pyr_lvl_0']['fun_val']):.4f}, iters={iters})"
                    )
            # the prior-chain carry: the final pyramid of the last REAL
            # window, as its record holds it (a resume reads the same)
            pyr = self.opt_results[f"datasample_idx_{chunk_idx[-1]}"][
                "solver_final_results"]["final_theta_pyr"]
            boundary = tuple(
                torch.as_tensor(pyr[f"pyr_lvl_{l}"], device=self.device)
                for l in range(self.solver_cfg.n_pyr_lvls)
            )
            if start + step < n:
                self.save_checkpoint(chunk_idx[-1], total)
        log(f"parallel solve: {n} windows, {mode} over {n_dev} rank(s), "
            f"{time.perf_counter() - t_begin:.2f} s")
        self._finish_solve(f"{n} windows, {mode} over {n_dev} rank(s)")
        return self.opt_results

    def _solve_one(self, solver, staged, prior, is_first):
        """Run one window (incl. n_repeat_solve repeats).

        Repeats feed the window's own result back as the prior and drop
        first-sample semantics after the first solve, as the reference does
        (solver.py:254-256). The result carries the FIRST repeat's
        prior_loss_lvl0 (the anomaly signal compares against the previous
        window's theta) and the host syncs of all repeats.
        """
        first_prior_loss, syncs = None, 0
        for _ in range(max(1, self.cfg.phases.n_repeat_solve)):
            res = solver(staged.window, prior, is_first)
            if first_prior_loss is None:
                first_prior_loss = res.prior_loss_lvl0
            syncs += res.n_host_syncs
            prior = res.final_theta_pyr
            is_first = False
        return res._replace(prior_loss_lvl0=first_prior_loss, n_host_syncs=syncs)

    @staticmethod
    def _anomalous(res) -> bool:
        """An armijo window whose level-0 optimum is worse than keeping the
        prior window's theta (or that hit NaN) is anomalous. The two losses
        cross in one transfer; the status is already on the host."""
        st = res.theta_opt_states[0]
        f = st.fun_val.reshape(())
        f_opt, f_prior = host.to_host(
            torch.stack([f, res.prior_loss_lvl0.reshape(()).to(f)])
        )
        return int(st.status) == 3 or not (f_opt <= f_prior)

    def _rescue_window(self, idx, staged, prior, armijo_res):
        """Re-solve an anomalous armijo window with strong Wolfe; keep the
        better of the two (by level-0 pre-handover loss). The Wolfe solver
        keeps its bracket+zoom budget (>= 10 trials) under the leaner armijo
        probe cap. Records the host syncs it made in `stats[idx]`."""
        if self._rescue_solver is None:
            rescue_cfg = dataclasses.replace(
                self.solver_cfg,
                line_search="wolfe",
                max_ls_evals=max(10, self.solver_cfg.max_ls_evals),
            )
            self._rescue_solver = make_window_solver(rescue_cfg, self.device)
        wolfe_res = self._solve_one(self._rescue_solver, staged, prior, False)
        f = armijo_res.theta_opt_states[0].fun_val.reshape(())
        f_a, f_w, f_prior = host.to_host(torch.stack([
            f,
            wolfe_res.theta_opt_states[0].fun_val.reshape(()).to(f),
            armijo_res.prior_loss_lvl0.reshape(()).to(f),
        ]))
        self.stats.setdefault(idx, {}).update(
            rescue_host_syncs=wolfe_res.n_host_syncs + 1, rescue_evals=_n_evals(wolfe_res)
        )
        self.n_rescue_attempts += 1
        warn(
            f"[{idx}] armijo anomaly (lvl-0 f={f_a:.6f} vs prior "
            f"f={f_prior:.6f}); wolfe rescue f={f_w:.6f}"
        )
        if f_w <= f_a or not np.isfinite(f_a):
            self.n_rescued += 1
            return wolfe_res
        return armijo_res

    def _delete_checkpoints_if_configured(self):
        if self.cfg.phases.delete_checkpoints_at_end and self._writes:
            for p in self.ckpt_dir.glob("checkpoint_*.npz"):
                p.unlink()

    def save_checkpoint(self, idx: int, total: int):
        if not self._writes:
            return
        path = self.ckpt_dir / f"checkpoint_{idx}_{total}.npz"
        save_opt_results(path, self.opt_results, self.cfg.to_dict())
        log(f"checkpoint saved: {path}")

    # ------------------------------------------------------------------ eval

    def _scale_to_sensor(self, theta) -> torch.Tensor:
        return scale_theta_to_sensor_size(
            torch.as_tensor(np.asarray(theta), device=self.device),
            tuple(self.cfg.dataset.sensor_size),
            self.cfg.solver.scale_theta_to_sensor_size_method,
        )

    def _final_theta_full(self, idx: int) -> torch.Tensor:
        rec = self.opt_results[f"datasample_idx_{idx}"]
        return self._scale_to_sensor(
            rec["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"]
        )

    def run_eval(self, opt_results_path: Optional[str] = None):
        if opt_results_path is None and not self.opt_results:
            # EVAL-only invocation (phases.solve=false): load this
            # experiment's saved artifact (exp_mgr.py:556-559, 836-848)
            default = self.out_dir / "opt_results.npz"
            if default.exists():
                opt_results_path = str(default)
                log(f"loading opt_results from {default}")
        if opt_results_path is not None:
            self.opt_results = EINCMOutputLoader().load_opt_results(opt_results_path)
        assert self.opt_results, "no opt_results in memory or on disk"
        if self.cfg.phases.parallel_eval:
            if not self.cfg.phases.eval_intermediate:
                return self.run_eval_parallel()
            warn(
                "phases.parallel_eval ignores eval_intermediate (per-iterate "
                "trajectories evaluate serially); running the serial eval path"
            )
        indices = sorted(
            int(k.replace("datasample_idx_", "")) for k in self.opt_results
        )
        for idx, staged in self._prefetch(indices):
            key = f"datasample_idx_{idx}"
            t0 = time.perf_counter()
            gt, mask, eval_inputs = self._eval_one_window(idx, staged)
            self.stats[idx]["eval_ms"] = (time.perf_counter() - t0) * 1e3
            if self.cfg.phases.eval_intermediate:
                inter = self._eval_intermediate(key, staged, gt, mask, eval_inputs)
                if inter is not None:
                    self.eval_results[key]["intermediate"] = inter
        self._finish_eval()
        return self.eval_results

    def _finish_eval(self):
        if self._writes:
            save_eval_results(
                self.out_dir / "eval_results.npz", self.eval_results, self.cfg.to_dict()
            )
            self.write_scores(self.extract_scores())

    def run_eval_parallel(self):
        """EVAL over the window mesh. Windows are independent at eval time
        (no prior chain): staged windows stream through the prefetcher into
        chunks of n_dev * parallel_eval_windows_per_device, each rank
        staging and evaluating its share of a chunk
        (parallel.batch.eval_batch_sharded: the serial path's per-window
        computation), the bundles gathered to every rank. Reference scope:
        exp_mgr.py:662-714 (a serial loop)."""
        from eincm_tpu_torch.evals.theta_metrics import format_eval_result
        from eincm_tpu_torch.parallel.batch import bundle_at, eval_batch_sharded, make_window_mesh

        indices = sorted(int(k.replace("datasample_idx_", "")) for k in self.opt_results)
        mesh = make_window_mesh(device=self.device)
        n_dev = mesh.size
        chunk = n_dev * max(1, self.cfg.phases.parallel_eval_windows_per_device)
        sensor = tuple(self.cfg.dataset.sensor_size)
        p = self.cfg.loss_params
        pvec = torch.tensor([p.alpha, p.beta, p.gamma, p.delta], dtype=torch.float32,
                            device=self.device)
        # the same on every rank
        mask = self._hood_mask()
        mask = None if mask is None else torch.as_tensor(mask, device=self.device)
        des = self.cfg.dataset.des_n_events
        if not des:
            raise ValueError(
                "phases.parallel_eval requires dataset.des_n_events (eval "
                "event windows pad to one length per chunk)"
            )
        bucket = _EVAL_PAD_BUCKET
        base_pad_e = max(bucket, -(-int(des) // bucket) * bucket)

        for start in range(0, len(indices), chunk):
            idxs = indices[start : start + chunk]
            b_pad = -(-len(idxs) // n_dev) * n_dev
            per = b_pad // n_dev
            # pad to a multiple of the mesh size by repeating the last
            # window (its results are discarded)
            mine = (idxs + [idxs[-1]] * (b_pad - len(idxs)))[mesh.rank * per : (mesh.rank + 1) * per]
            by_idx = dict(self._prefetch(list(dict.fromkeys(mine))))
            staged_list = [by_idx[i] for i in mine]

            # eval_events are boundary-sliced from the raw stream and NOT
            # capped by des_n_events, so a busy window can exceed the
            # des-derived pad: grow it to the chunk's maximum in buckets
            info = mesh.all_gather((
                max(len(s.eval_events["x"]) for s in staged_list),
                sorted({s.gt_flow is not None for s in staged_list}),
            ))
            gts = {g for _, flags in info for g in flags}
            if len(gts) != 1:
                raise ValueError(
                    "parallel_eval chunk mixes windows with and without "
                    "gt_flow; GT presence must be uniform per sequence"
                )
            has_gt = gts.pop()
            pad_e = max(base_pad_e, -(-max(m for m, _ in info) // bucket) * bucket)

            def padded_events(s):
                ev = s.eval_events
                e = len(ev["x"])
                out = np.full((3, pad_e), np.nan, np.float32)
                out[0, :e], out[1, :e], out[2, :e] = ev["x"], ev["y"], ev["t"]
                return out

            evs = self._f32(np.stack([padded_events(s) for s in staged_list]))
            theta = self._f32(np.stack([
                np.asarray(self.opt_results[f"datasample_idx_{i}"]["solver_final_results"][
                    "final_theta_pyr"]["pyr_lvl_0"], np.float32)
                for i in mine
            ]))
            gt = self._f32(np.stack([s.gt_flow for s in staged_list])) if has_gt else None
            t0 = time.perf_counter()
            small = eval_batch_sharded(
                theta, evs[:, 0], evs[:, 1], evs[:, 2],
                torch.stack([s.window.edges for s in staged_list]),
                torch.stack([s.window.edge_ts for s in staged_list]),
                gt, mask, pvec, mesh, sensor,
                self.cfg.solver.scale_theta_to_sensor_size_method,
            )
            ms = (time.perf_counter() - t0) * 1e3 / per
            for i in set(mine) & set(idxs):
                self.stats.setdefault(i, {})["eval_ms"] = ms
            meta = [m for part in mesh.all_gather(
                [(np.asarray(s.eval_ts), s.eval_ts_units) for s in staged_list]) for m in part]
            for pos, idx in enumerate(idxs):
                key = f"datasample_idx_{idx}"
                time_str, eval_str, evals = format_eval_result(bundle_at(small, pos), sensor, has_gt)
                self.eval_results[key] = {
                    "evals": _as_jax_dtypes(evals),
                    "eval_ts": meta[pos][0],
                    "eval_ts_units": meta[pos][1],
                }
                if self._writes:
                    log(f"{time_str} {key}: {eval_str.strip()}")

        self._finish_eval()
        ok(f"parallel eval: {len(indices)} windows over {n_dev} rank(s), chunks of {chunk}")
        return self.eval_results

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def _eval_one_window(self, idx: int, staged: StagedSample):
        """Evaluate one solved window (the EVAL phase's loop and the eager
        in-solve evaluation, exp_mgr.py:646-651). Returns (gt, mask,
        eval_inputs) so the intermediate-iterate path reuses the padded
        events and the window statics."""
        key = f"datasample_idx_{idx}"
        theta_full = self._final_theta_full(idx)
        gt = None if staged.gt_flow is None else self._f32(staged.gt_flow)
        mask = self._hood_mask()
        mask = None if mask is None else torch.as_tensor(mask, device=self.device)
        ev = staged.eval_events
        sensor = tuple(self.cfg.dataset.sensor_size)
        exs, eys, ets, wstat = prepare_eval_inputs(
            self._f32(ev["x"]), self._f32(ev["y"]), self._f32(ev["t"]),
            staged.window.edges, sensor, dtype=theta_full.dtype,
        )
        eval_inputs = (exs, eys, ets, wstat)
        time_str, eval_str, evals, _ = evaluate_theta_array(
            theta_full, exs, eys, ets, staged.window.edges, staged.window.edge_ts,
            gt, self.cfg.loss_params, sensor,
            err_eval_event_mask=mask, window_statics=wstat,
        )
        self.eval_results[key] = {
            "evals": _as_jax_dtypes(evals),
            "eval_ts": np.asarray(staged.eval_ts),
            "eval_ts_units": staged.eval_ts_units,
        }
        log(f"{time_str} {key}: {eval_str.strip()}")
        return gt, mask, eval_inputs

    def _eager_hooks(self, idx: int, staged: StagedSample):
        """Eager per-window EVAL/PLOT right after a window's solve results
        are recorded (reference exp_mgr.py:646-656 with the every-N gates)."""
        ph = self.cfg.phases
        if ph.eager_eval and idx % max(1, ph.eager_eval_every) == 0:
            self._eval_one_window(idx, staged)
        if ph.eager_plot and self._writes and idx % max(1, ph.eager_plot_every) == 0:
            if getattr(self, "_eager_plotter", None) is None:
                from eincm_tpu_torch.experiments.plotters import EINCMExperimentPlotter

                self._eager_plotter = EINCMExperimentPlotter(
                    self.cfg, self.out_dir / "plots"
                )
            self._eager_plotter.plot_end_results(
                idx, staged, self._final_theta_full(idx)
            )

    def _hood_mask(self):
        if (
            self.cfg.dataset.kind == "mvsec"
            and self.cfg.dataset.sequence_name == "outdoor_day1"
        ):
            # car-hood mask: rows >= 190 excluded (exp_mgr.py:429-432)
            mask = np.ones(tuple(self.cfg.dataset.sensor_size), bool)
            mask[190:] = False
            return mask
        return None

    def _eval_intermediate(self, key, staged, gt, mask, eval_inputs):
        """Evaluate every recorded level-0 BFGS iterate of one window (the
        post-hoc equivalent of the reference's eval-during-solve callback,
        src/eincm/callbacks.py:140-149), reusing the window's padded events
        and statics from `eval_inputs`."""
        rec = self.opt_results[key]["solver_intermediate_results"]["theta_opt"]
        thetas = rec.get("thetas", {}).get("pyr_lvl_0")
        if thetas is None:
            warn(
                "phases.eval_intermediate needs solver.collect_intermediate; "
                "no recorded iterates found"
            )
            return None
        shape = (*self.solver_cfg.level_shape(0), 2)
        sensor = tuple(self.cfg.dataset.sensor_size)
        exs, eys, ets, wstat = eval_inputs
        per_iter: Dict[str, list] = {}
        for it in range(thetas.shape[0]):
            theta_full = self._scale_to_sensor(np.asarray(thetas[it]).reshape(shape))
            _, _, evals_i, _ = evaluate_theta_array(
                theta_full, exs, eys, ets, staged.window.edges,
                staged.window.edge_ts, gt, self.cfg.loss_params, sensor,
                err_eval_event_mask=mask, window_statics=wstat,
            )
            for k, v in evals_i.items():
                arr = np.asarray(v)
                if arr.ndim == 0:
                    per_iter.setdefault(k, []).append(float(arr))
        return {k: np.asarray(v) for k, v in per_iter.items()}

    # ---------------------------------------------------------------- scores

    def extract_scores(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per-window metrics into min | mean+-std | max
        (exp_mgr.py:821-833)."""
        per_metric: Dict[str, list] = {}
        for rec in self.eval_results.values():
            for k, v in rec["evals"].items():
                arr = np.asarray(v)
                if arr.ndim == 0:
                    per_metric.setdefault(k, []).append(float(arr))
        scores = {}
        for k, vals in per_metric.items():
            a = np.asarray(vals)
            scores[k] = {
                "min": float(a.min()),
                "mean": float(a.mean()),
                "std": float(a.std()),
                "max": float(a.max()),
            }
            if self.cfg.dataset.kind == "dsec" and self.cfg.dataset.extended:
                sub = a[_EXTENDED_SUBSET][1:]
                if len(sub):
                    scores[k]["orig_subset_mean"] = float(sub.mean())
                    scores[k]["orig_subset_std"] = float(sub.std())
        return scores

    def write_scores(self, scores: Dict[str, Dict[str, float]]):
        path = self.out_dir / "scores.txt"
        with open(path, "w") as f:
            f.write(f"# {self.cfg.experiment_name} — per-metric aggregation\n")
            f.write("# metric: min | mean±std | max\n")
            for k in sorted(scores):
                s = scores[k]
                line = (
                    f"{k}: {s['min']:.6f} | {s['mean']:.6f}±{s['std']:.6f} "
                    f"| {s['max']:.6f}"
                )
                if "orig_subset_mean" in s:
                    line += (
                        f"  (orig-ts subset: "
                        f"{s['orig_subset_mean']:.6f}±{s['orig_subset_std']:.6f})"
                    )
                f.write(line + "\n")
        ok(f"scores.txt written: {path}")

    # ------------------------------------------------------------------ plot

    def run_plot(self, opt_results_path=None, eval_results_path=None):
        from eincm_tpu_torch.experiments.plotters import EINCMExperimentPlotter

        if self.cfg.mpl_rcparams:
            # the mpl_rcparams config group, applied before plotting
            # (src/experiments/e00/__main__.py:29-31)
            import matplotlib

            matplotlib.rcParams.update(self.cfg.mpl_rcparams)
        if opt_results_path is None and not self.opt_results:
            default = self.out_dir / "opt_results.npz"
            if default.exists():
                opt_results_path = str(default)
        if eval_results_path is None and not self.eval_results:
            default_ev = self.out_dir / "eval_results.npz"
            if default_ev.exists():
                eval_results_path = str(default_ev)
        if opt_results_path is not None:
            self.opt_results = EINCMOutputLoader().load_opt_results(opt_results_path)
        if eval_results_path is not None:
            self.eval_results = EINCMOutputLoader().load_eval_results(eval_results_path)
        dl = self._prepare_dataloader()
        plotter = EINCMExperimentPlotter(self.cfg, self.out_dir / "plots")
        for key in sorted(
            self.opt_results, key=lambda k: int(k.replace("datasample_idx_", ""))
        ):
            idx = int(key.replace("datasample_idx_", ""))
            staged = self.stage(dl[idx])
            plotter.plot_end_results(idx, staged, self._final_theta_full(idx))

            # handover diagnostic at the finest level (reference
            # plotters.py:448-473); first windows skip handover
            fin = self.opt_results[key]["solver_final_results"]
            w0 = float(np.asarray(fin["final_handover_weight_pyr"]["pyr_lvl_0"]))
            pre0 = np.asarray(fin["pre_handover_theta_pyr"]["pyr_lvl_0"])
            post0 = np.asarray(fin["final_theta_pyr"]["pyr_lvl_0"])
            if not np.array_equal(pre0, post0):
                plotter.plot_handover(
                    idx, pre0, np.asarray(fin["prior_theta_pyr"]["pyr_lvl_0"]),
                    post0, alpha_ho=w0, pyr=0,
                )

            # per-step figures from recorded iterates (reference
            # plotters.py:493-645)
            inter = self.opt_results[key]["solver_intermediate_results"]["theta_opt"]
            thetas = inter.get("thetas", {}).get("pyr_lvl_0")
            if thetas is not None and len(thetas):
                shape = (*self.solver_cfg.level_shape(0), 2)
                picks = sorted({0, len(thetas) // 2, len(thetas) - 1})
                prev_full = None
                for it in picks:
                    th_full = self._scale_to_sensor(
                        np.asarray(thetas[it]).reshape(shape)
                    ).cpu().numpy()
                    plotter.plot_step_result_detail(
                        idx, staged, th_full, prev_full, itr=it, pyr=0
                    )
                    prev_full = th_full
        if self.eval_results:
            plotter.plot_metric_sequences(self.eval_results)
        plotter.assemble_video()
        return plotter

    # ------------------------------------------------------------------- run

    def run(self):
        if self._writes:  # rank 0 alone plots
            check_plotting(self.cfg)
        if self.cfg.phases.solve:
            self.run_solver()
        if self.cfg.phases.eval:
            self.run_eval()
        if self.cfg.phases.plot and self._writes:
            self.run_plot()
        return self
