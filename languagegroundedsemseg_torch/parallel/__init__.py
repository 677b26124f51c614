"""Data parallelism over ``torch.distributed``: one process per rank.

Counterpart of ``languagegroundedsemseg_tpu/parallel/``: the process group
and this rank's device (``mesh.make_mesh``), the gradient average and the
weight broadcast (``dp``), and the collectives (``collectives``), whose
all-reduce carries the gradient back across ranks as JAX's psum does.
SyncBN is ``models.layers.convert_sync_batchnorm``.
"""

from languagegroundedsemseg_torch.parallel.dp import average_gradients, broadcast_module
from languagegroundedsemseg_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "average_gradients", "broadcast_module"]
