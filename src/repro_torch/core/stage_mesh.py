"""Stage-2 bucket sizing (the port of ``repro/core/stage_mesh.py``'s
``stage2_capacity``; placement across submeshes is one device here)."""
from __future__ import annotations

import numpy as np


def stage2_capacity(batch: int, p: float, multiple: int = 8,
                    slack: float = 0.1) -> int:
    """Bucket size for the stage-2 hard-sample slab: ceil((p+slack)*B),
    rounded up to ``multiple``, clamped to [1, batch] (p=0 still provisions
    one ``multiple``-sized bucket; a batch smaller than the multiple caps
    at the batch)."""
    c = int(np.ceil((p + slack) * batch))
    c = max(multiple, ((c + multiple - 1) // multiple) * multiple)
    return max(1, min(c, batch))
