"""MCA — Modular Component Architecture machinery.

Mirrors the reference's load-bearing pattern (``opal/mca/base``): a
*framework* is a fixed interface, a *component* an implementation that can
be queried for a priority, a *module* a per-communicator instance.
"""
from ompi_tpu_torch.mca.base import Framework, Component, register_framework, get_framework  # noqa: F401
from ompi_tpu_torch.mca.var import var_register, var_get, var_set, var_dump, var_source  # noqa: F401
