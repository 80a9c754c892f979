"""CLI entry point: python -m eincm_tpu_torch.experiments [--config X] [--device D] [k=v ...]

The port of `python -m eincm_tpu.experiments` (reference hydra entry,
src/experiments/e00/__main__.py:25-38), with the same arguments plus
`--device` (default cuda; a cuda device without CUDA raises):

    python -m eincm_tpu_torch.experiments --config configs/mvsec_indoor.yaml \\
        dataset.kind=synthetic phases.checkpoint_every_percent=25
    python -m eincm_tpu_torch.experiments --device cpu --config configs/synthetic.yaml

The config raises for the settings the port does not run (distributed,
jax_config, compilation_cache_dir).
"""

from __future__ import annotations

import argparse

from eincm_tpu_torch.experiments.config import load_config
from eincm_tpu_torch.experiments.manager import EINCMExperiment
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
    log(f"experiment '{cfg.experiment_name}' on {cfg.dataset.kind}/"
        f"{cfg.dataset.sequence_name}, device {args.device}")
    exp = EINCMExperiment(cfg, device=args.device)
    exp.run()
    return exp


if __name__ == "__main__":
    main()
