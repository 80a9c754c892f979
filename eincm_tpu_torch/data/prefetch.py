"""Host-side staging prefetcher: overlap edge extraction with device solves.

The reference stages each datasample (OpenCV edge extraction on the host CPU)
synchronously between solves (src/experiments/e00/exp_mgr.py:620-634). Here a
small thread pool stages the next `depth` windows while the device solves the
current one — the pipeline-parallel layer from SURVEY.md §2.3. Edge
extraction is numpy/scipy/C++ work that releases the GIL, so the overlap is
real.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence


class StagingPrefetcher:
    """Iterate (idx, staged_sample) with background staging lookahead.

    Args:
        dataloader: indexable loader (the datasample dict contract).
        indices: window indices to visit, in order.
        stage_fn: datasample dict -> StagedSample (runs in worker threads).
        depth: number of windows staged ahead of consumption.
    """

    def __init__(
        self,
        dataloader,
        indices: Sequence[int],
        stage_fn: Callable,
        depth: int = 2,
    ):
        self.dataloader = dataloader
        self.indices = list(indices)
        self.stage_fn = stage_fn
        self.depth = max(1, depth)

    def __iter__(self) -> Iterator:
        if not self.indices:
            return
        with ThreadPoolExecutor(max_workers=self.depth) as pool:
            # keyed by POSITION, not index value: `indices` is an arbitrary
            # sequence and may repeat an index (a value-keyed dict would
            # overwrite the pending future and crash on the second pop)
            futures = {}
            ahead = min(self.depth, len(self.indices))
            for j in range(ahead):
                futures[j] = pool.submit(self._stage, self.indices[j])
            for pos, idx in enumerate(self.indices):
                nxt = pos + ahead
                if nxt < len(self.indices):
                    futures[nxt] = pool.submit(self._stage, self.indices[nxt])
                yield idx, futures.pop(pos).result()

    def _stage(self, idx: int):
        return self.stage_fn(self.dataloader[idx])
