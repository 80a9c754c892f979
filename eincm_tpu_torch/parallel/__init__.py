"""The window axis over `torch.distributed`: batched and sequence-sharded
solves, the sharded EVAL, and the multi-process runtime (one process per
device, gloo between them)."""

from eincm_tpu_torch.parallel.batch import (
    WindowMesh,
    eval_batch_sharded,
    make_window_mesh,
    sequence_shard_solve,
    solve_window_batch,
    solve_window_batch_sharded,
    two_pass_sequence_solve,
)
from eincm_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
    is_multi_process,
    process_info,
)
