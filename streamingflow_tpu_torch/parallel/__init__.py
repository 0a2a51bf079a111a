"""Data-parallel training on ``torch.distributed`` (port of
streamingflow_tpu/parallel/)."""
from .collect import (combine_metrics, gather_across_processes,
                      psum_metric_states, sum_across_processes)
from .mesh import (DataGroup, complete_batches, init_distributed,
                   make_data_parallel_step, make_mesh, participants,
                   shard_batch)
