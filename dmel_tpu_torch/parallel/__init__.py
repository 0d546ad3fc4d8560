"""Parallelism (counterpart of ``dmel_tpu/parallel``): data parallelism
over a mesh of ranks (:mod:`~dmel_tpu_torch.parallel.mesh`), and a
sweep's trials packed into one program
(:mod:`~dmel_tpu_torch.parallel.trials`), whose trial axis a mesh may
split."""

from dmel_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding, initialize_distributed, make_mesh, place_global_batch,
    replicate, replicated, shard_batch)
from dmel_tpu_torch.parallel.trials import (fit_trials,  # noqa: F401
                                            make_multitrial_eval,
                                            make_multitrial_step)

__all__ = ["batch_sharding", "initialize_distributed", "make_mesh",
           "place_global_batch", "replicate", "replicated", "shard_batch",
           "fit_trials", "make_multitrial_eval", "make_multitrial_step"]
