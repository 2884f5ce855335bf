"""The parallel layer of the port on ``torch.distributed``: process groups
(``dist``) and the data x model mesh with its sharding rules (``mesh``)."""

from valle_tpu_torch.parallel import dist, mesh
from valle_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_parameters_

__all__ = ["Mesh", "dist", "mesh", "shard_batch", "shard_parameters_"]
