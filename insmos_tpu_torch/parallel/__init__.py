from .mesh import (World, all_reduce_grads, all_reduce_sum,  # noqa: F401
                   close_world, data_world_for_batch, init_world, rank_device,
                   replicate, shard_batch)
