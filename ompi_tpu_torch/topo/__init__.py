"""Process topologies — mirrors ``ompi/mca/topo``: cartesian, graph and
distributed-graph topologies (``cart``), neighbor collectives on the
device (``neighbor``) and communication-aware rank placement
(``treematch``)."""
from ompi_tpu_torch.topo.cart import (CartTopology, DistGraphTopology,  # noqa: F401
                                      GraphTopology, dims_create)
