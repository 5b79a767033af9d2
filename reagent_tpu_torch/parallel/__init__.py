"""Distributed execution: meshes over ``torch.distributed`` and the
data-parallel and model-parallel learners.

Port of ``reagent_tpu/parallel/`` (reference: data parallelism through
PyTorch-Lightning DDP, workflow/utils.py:135-165, docs/distributed.rst, and
the process-group all-reduce of evolution strategies,
training/gradient_free/es_worker.py:37-46).  A mesh is this rank's view of
the first ranks of an initialised default process group, laid out by axis
name, with one process group an axis; the trainer state is replicated, the
batch sharded over the ``data`` axis, and the step reduces the gradients
over that axis's group.
"""

from reagent_tpu_torch.parallel.data_parallel import (
    Mesh,
    make_data_parallel_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from reagent_tpu_torch.parallel.model_parallel import (
    embedding_specs,
    make_2d_mesh,
    make_model_parallel_train_step,
    shard_state,
)
from reagent_tpu_torch.parallel.scaling import (
    analytic_dp_allreduce_model,
    host_shard_batch,
    measure_scaling_efficiency,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_data_parallel_train_step",
    "replicate",
    "shard_batch",
    "embedding_specs",
    "make_2d_mesh",
    "make_model_parallel_train_step",
    "shard_state",
    "analytic_dp_allreduce_model",
    "host_shard_batch",
    "measure_scaling_efficiency",
]
