"""Multi-process data-parallel training (counterpart of
``detmatch_tpu/parallel/``): one process per device, each holding its
rows of the global batch, with every batch reduction made global so that
N processes compute what one process computes on the same global batch
(``distributed.py``)."""
from .distributed import (all_reduce_flat, all_reduce_grads,
                          broadcast_state, for_each_global_row, global_count,
                          global_rows, global_sum, global_sum_grad,
                          init_distributed, is_primary, local_shard,
                          process_count, process_index, reduce_logs,
                          rows_in_global_order, shutdown, start_group)

__all__ = [
    "all_reduce_flat", "all_reduce_grads", "broadcast_state",
    "for_each_global_row", "global_count", "global_rows", "global_sum",
    "global_sum_grad", "init_distributed", "is_primary", "local_shard",
    "process_count", "process_index", "reduce_logs", "rows_in_global_order",
    "shutdown", "start_group",
]
