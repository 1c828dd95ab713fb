"""Data parallelism on ``torch.distributed``: rays sharded over a 1-D
``"data"`` group of processes, one device each, parameters replicated and
gradients all-reduced (``training.loop``); render and score shard each ray
chunk over the local devices of one process (``views.make_sharded_render_chunk``).

Counterpart of ``minimal_nerf_tpu/parallel/``.
"""

from minimal_nerf_torch.parallel import distributed  # noqa: F401
from minimal_nerf_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    local_devices,
    make_mesh,
    shard_batch,
)
