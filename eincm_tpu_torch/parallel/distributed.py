"""Multi-process runtime: one process per device over `torch.distributed`.

Port of eincm_tpu/parallel/distributed.py. The JAX package is a single
controller over a device mesh that `jax.distributed.initialize` extends
over hosts. The port uses PyTorch's idiom instead: one process per device,
the processes joined in a `torch.distributed` process group. The window
mesh of `parallel/batch.py` is that group's ranks, each owning one
explicit `torch.device`.

Everything that crosses ranks goes over the `gloo` backend: one theta
pyramid per chunk boundary (682 floats at 5 levels) and the final
per-window records, which the manager reads on the host anyway. The solves
stay on each rank's device; the two copies to the host are explicit, not a
fallback. gloo also lets two ranks share one GPU, which NCCL refuses
("duplicate GPU"), so a machine with one card can run the cross-rank path.

Every collective runs under the process group's timeout, which
`initialize_distributed` always sets (`COLLECTIVE_TIMEOUT` unless the
caller passes another): a dead rank fails the run instead of hanging it.

Gated behind `DistributedConfig.enable`, so single-process runs (and the
test suite) never touch the rendezvous.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# a rank waits at most this long for its peers at any collective; the
# schedules' waits are bounded by the slowest rank's share of a super-step
COLLECTIVE_TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class DistributedConfig:
    """Multi-process runtime settings (see experiments.config for the YAML
    keys); the fields of the JAX package's.

    With `coordinator_address`, `num_processes` and `process_id` all None,
    the process group reads torchrun's environment (`init_method="env://"`:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); explicit values support
    manual bring-up:

        coordinator_address: "host:port" of process 0 (a TCP rendezvous).
        num_processes: world size.
        process_id: this process's rank.
        local_device_ids: this process's device, one CUDA index (one
            device per process; more than one raises). Without it, the
            index is LOCAL_RANK, else 0.
    """

    enable: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[tuple] = None


def check_local_device_ids(cfg: DistributedConfig) -> None:
    """Raise unless `local_device_ids` is unset or names one device."""
    ids = cfg.local_device_ids
    if ids is not None and len(tuple(ids)) != 1:
        raise NotImplementedError(
            f"distributed.local_device_ids {ids!r}: the port runs one device "
            "per process; give each process one id"
        )


def rank_device(cfg: DistributedConfig, device="cuda") -> torch.device:
    """This process's device. A CUDA device without an index takes it from
    `local_device_ids`, else from LOCAL_RANK (torchrun), else 0; any other
    device (an indexed CUDA device, the CPU the tests ask for) is returned
    as given. Nothing here turns a CUDA request into the CPU."""
    check_local_device_ids(cfg)
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if cfg.local_device_ids is not None:
        index = int(tuple(cfg.local_device_ids)[0])
    else:
        index = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", index)


def initialize_distributed(
    cfg: DistributedConfig, timeout: timedelta = COLLECTIVE_TIMEOUT
) -> bool:
    """Join the gloo process group if enabled; returns True if the process
    is (now) part of a multi-process group.

    Safe to call more than once: a process already in a group keeps it.
    """
    if not cfg.enable:
        return False
    check_local_device_ids(cfg)
    if dist.is_initialized():
        return is_multi_process()
    rendezvous = (cfg.coordinator_address, cfg.num_processes, cfg.process_id)
    if all(v is None for v in rendezvous):
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    elif any(v is None for v in rendezvous):
        raise ValueError(
            "distributed: give coordinator_address, num_processes and "
            "process_id together (or none of them, for torchrun's env://)"
        )
    else:
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{cfg.coordinator_address}",
            world_size=int(cfg.num_processes),
            rank=int(cfg.process_id),
            timeout=timeout,
        )
    # the contract is "True iff part of a multi-process group": an enabled
    # but single-process init (num_processes=1) must not steer callers onto
    # a multi-process branch
    return is_multi_process()


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_info(device=None) -> str:
    where = "" if device is None else f", device {torch.device(device)}"
    backend = f" ({dist.get_backend()})" if process_count() > 1 else ""
    return (
        f"process {process_rank()}/{process_count()}{backend}{where}, "
        f"1 local / {process_count()} global devices"
    )
