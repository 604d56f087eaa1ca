"""Multi-device runs of the port: one process per device, a
:class:`Mesh` per process group (counterpart of ``pesr_tpu/parallel``)."""

from pesr_torch.parallel.mesh import (LAUNCH_HINT, Mesh,  # noqa: F401
                                      all_agree, all_gather_batch,
                                      all_reduce_mean_, barrier, batch_mean,
                                      batch_sharding, default_backend,
                                      initialize_distributed, is_primary,
                                      local_device, make_mesh, max_all_,
                                      replicated,
                                      shard_batch, shard_pytree_replicated,
                                      sum_all)
