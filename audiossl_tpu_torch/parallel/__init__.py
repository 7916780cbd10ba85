"""Data parallelism over ``torch.distributed`` (port of
``audiossl_tpu/parallel``): ``mesh`` holds the collectives, ZeRO-1's
partition and the downstream drivers' batch rows, ``launch`` starts
ranks, ``dryrun`` checks the steps at world size n."""
from audiossl_tpu_torch.parallel.mesh import (World, all_gather_rows,
                                              all_reduce_sum, batch_rows,
                                              broadcast_groups,
                                              broadcast_object, data_world,
                                              gather_rows, global_batch_size,
                                              init_from_env, local_rows,
                                              partition_leaves, reduce_grads,
                                              replicated, shard_batch, world)

__all__ = ["World", "all_gather_rows", "all_reduce_sum", "batch_rows",
           "broadcast_groups", "broadcast_object", "data_world",
           "gather_rows", "global_batch_size", "init_from_env", "local_rows",
           "partition_leaves", "reduce_grads", "replicated", "shard_batch",
           "world"]
