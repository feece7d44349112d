"""Multi-process evaluation collation (port of
``trinerflet_tpu/parallel/multihost.py``).

Views are split round-robin over the processes; each renders and scores its
own, and the per-view metric rows are gathered so that every process ends
with the full table; only the primary process writes the table. On a
``Mesh`` the split is over the data index: the ranks of one model group
render the same views together, because their channel shards meet in the
model reduction. Without a mesh the split is over the default group's
ranks, and with no group every function is the identity.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .sharding import DATA_AXIS, Mesh

__all__ = ["process_view_slice", "allgather_rows", "is_primary"]


def _index_count(mesh: Optional[Mesh]):
    if mesh is not None:
        return mesh.data_index, mesh.data
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary(mesh: Optional[Mesh] = None) -> bool:
    """Rank 0 of the grid (or of the default group), or the only process."""
    if mesh is not None:
        return mesh.rank == 0
    return _index_count(None)[0] == 0


def process_view_slice(num_views: int, mesh: Optional[Mesh] = None) -> List[int]:
    """This process's views: index, index + count, ... (the reference's
    DistributedSampler stride layout)."""
    i, n = _index_count(mesh)
    return list(range(i, num_views, n))


def allgather_rows(rows: np.ndarray, total: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Every process's metric rows, sorted by view id.

    rows: (n_local, D) float32 whose first column is the view id. Each
    process pads its rows with NaN to ceil(total / count), the padded blocks
    are gathered, the padding is dropped and the rows are sorted. With one
    process the rows come back sorted."""
    rows = np.asarray(rows, np.float32).reshape(-1, rows.shape[-1] if rows.ndim > 1 else 1)
    _, n = _index_count(mesh)
    if n == 1:
        return rows[np.argsort(rows[:, 0], kind="stable")]
    per = -(-total // n)
    pad = np.full((per - len(rows), rows.shape[1]), np.nan, np.float32)
    block = torch.from_numpy(np.concatenate([rows, pad]) if len(pad) else rows)
    if mesh is not None:
        gathered = mesh.all_gather(block, DATA_AXIS).numpy()
    else:
        if dist.get_backend() == "nccl":
            block = block.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(block) for _ in range(n)]
        dist.all_gather(parts, block)
        gathered = torch.cat(parts).cpu().numpy()
    gathered = gathered[~np.isnan(gathered[:, 0])]
    return gathered[np.argsort(gathered[:, 0], kind="stable")]
