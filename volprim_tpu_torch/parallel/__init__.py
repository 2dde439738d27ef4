"""Data parallelism over processes (volprim_tpu.parallel)."""

from .mesh import (
    Mesh,
    data_mesh,
    gather_blocks,
    init_multihost,
    rank_generator,
    replicate,
    shard_rays,
    sharded_grad_step,
    sum_grads,
    sum_parts,
)
