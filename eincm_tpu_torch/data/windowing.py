"""Fixed-size event-window selection shared by every dataset loader.

All reference loaders implement the same des_n_events policy
(dsec_loader.py:296-312, mvsec_loader.py:276-291, ecd_loader.py:99-114):

- deficit: extend the window symmetrically (ceil-left / floor-right), clipped
  to the stream bounds;
- surplus: keep the latest (or earliest) des_n_events.

Fixed event counts are what make windows batch under vmap and compile once on
TPU — this is the padding discipline from SURVEY.md §5 "long-context".
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def adjust_event_window(
    idx_start: int,
    idx_end: int,
    des_n_events: int | None,
    n_total: int,
    prefer_latest_events: bool = True,
) -> Tuple[int, int, int, int]:
    """Adjust [idx_start, idx_end) to contain exactly des_n_events if possible.

    Returns:
        (idx_start, idx_end, n_event_deficiency, orig_n_events)
    """
    orig_n_events = idx_end - idx_start
    if des_n_events is None:
        return idx_start, idx_end, 0, orig_n_events

    deficiency = des_n_events - orig_n_events
    if deficiency > 0:
        idx_start -= int(np.ceil(deficiency / 2))
        idx_end += int(np.floor(deficiency / 2))
        idx_start = max(0, idx_start)
        idx_end = min(idx_end, n_total)
    elif deficiency < 0:
        if prefer_latest_events:
            idx_start = idx_end - des_n_events
        else:
            idx_end = idx_start + des_n_events
    return idx_start, idx_end, deficiency, orig_n_events
