"""Multi-process training and evaluation over ``torch.distributed`` (port
of ``trinerflet_tpu/parallel``): the (data, model) process grid and its
layouts (``sharding``), the evaluation's view split and row gather
(``multihost``), and the launcher with its dry run (``launch``)."""

from .multihost import allgather_rows, is_primary, process_view_slice
from .sharding import (DATA_AXIS, MODEL_AXIS, Mesh, active_mesh, current_data_mesh, gather_params,
                       gather_state, make_mesh, model_sum, param_shardings, shard_params,
                       shard_state, state_shardings)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "active_mesh", "current_data_mesh", "make_mesh",
           "param_shardings", "state_shardings", "shard_params", "shard_state", "gather_params",
           "gather_state", "model_sum", "process_view_slice", "allgather_rows", "is_primary"]
