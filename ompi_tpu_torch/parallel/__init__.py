"""The in-graph communicator tier: a single-controller rank mesh
(``mesh``), collectives over its axes (``ingraph``), and the parallel
strategies built on them — ring attention, Ulysses, Switch MoE, GPipe."""
from ompi_tpu_torch.parallel.ingraph import InGraphComm  # noqa: F401
from ompi_tpu_torch.parallel.mesh import Mesh, P  # noqa: F401
