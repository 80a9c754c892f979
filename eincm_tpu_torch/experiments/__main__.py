"""CLI entry point: python -m eincm_tpu_torch.experiments [--config X] [--device D] [k=v ...]

The port of `python -m eincm_tpu.experiments` (reference hydra entry,
src/experiments/e00/__main__.py:25-38), with the same arguments plus
`--device` (default cuda; a cuda device without CUDA raises):

    python -m eincm_tpu_torch.experiments --config configs/mvsec_indoor.yaml \\
        dataset.kind=synthetic phases.checkpoint_every_percent=25
    python -m eincm_tpu_torch.experiments --device cpu --config configs/synthetic.yaml

With `distributed.enable=true` the process joins a gloo process group
before the experiment is built (one process per device): under torchrun
with no other `distributed.*` key, or with explicit keys,

    python -m eincm_tpu_torch.experiments --config configs/dsec_test.yaml \
        phases.parallel_windows=true distributed.enable=true \
        distributed.coordinator_address=127.0.0.1:29500 \
        distributed.num_processes=2 distributed.process_id=0 \
        "distributed.local_device_ids=[0]"

The config raises for the settings the port does not run (jax_config,
compilation_cache_dir, more than one local device id), and `phases.plot`
or `phases.eager_plot` raises before anything is staged where matplotlib
(or, for the plot's video, PIL) does not import: pass `phases.plot=false`
on the card's machine.
"""

from __future__ import annotations

import argparse

import torch

from eincm_tpu_torch.experiments.config import load_config
from eincm_tpu_torch.experiments.manager import EINCMExperiment, check_plotting
from eincm_tpu_torch.parallel.distributed import (
    initialize_distributed,
    process_info,
    process_rank,
    rank_device,
)
from eincm_tpu_torch.utils.console import log


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="eincm_tpu_torch.experiments",
        description="Run an EINCM experiment (solve / eval / plot phases).",
    )
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default cuda)"
    )
    parser.add_argument(
        "overrides", nargs="*", help="dotted overrides, e.g. alpha=60"
    )
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    if cfg.distributed.enable:
        # before the experiment is built: its mesh is the process group
        initialize_distributed(cfg.distributed)
    if process_rank() == 0:  # rank 0 alone plots
        check_plotting(cfg)
    # a bare cuda takes its index here (set_device needs one)
    device = rank_device(cfg.distributed, args.device)
    if cfg.distributed.enable:
        log(process_info(device))
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(device)  # the kernels launch on the current device
    log(f"experiment '{cfg.experiment_name}' on {cfg.dataset.kind}/"
        f"{cfg.dataset.sequence_name}, device {device}")
    exp = EINCMExperiment(cfg, device=device)
    exp.run()
    return exp


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
