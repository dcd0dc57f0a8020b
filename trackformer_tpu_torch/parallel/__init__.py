"""Several processes: process groups, the data x model layout, object
gathers (`dist`), and tensor parallelism (`tp`)."""
from .dist import (Layout, all_gather_objects, init_process_group, layout,
                   make_layout, rank, shard_batch, world_size)
