"""Data parallelism over ``torch.distributed`` (the pretraining half of
``audiossl_tpu/parallel``): ``mesh`` holds the collectives and ZeRO-1's
partition, ``launch`` starts ranks, ``dryrun`` checks a step at world
size n."""
from audiossl_tpu_torch.parallel.mesh import (World, all_gather_rows,
                                              all_reduce_sum,
                                              broadcast_groups,
                                              global_batch_size,
                                              init_from_env, local_rows,
                                              partition_leaves, reduce_grads,
                                              world)

__all__ = ["World", "all_gather_rows", "all_reduce_sum", "broadcast_groups",
           "global_batch_size", "init_from_env", "local_rows",
           "partition_leaves", "reduce_grads", "world"]
