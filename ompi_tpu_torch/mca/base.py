"""Framework/component/module machinery with priority selection.

Mirrors the boundary (not the DSO machinery) of the reference's MCA:
framework open/close (``opal/mca/base/mca_base_framework.c``), component
discovery (``mca_base_component_find.c``) and priority-sorted selection at
communicator scope (``ompi/mca/coll/base/coll_base_comm_select.c:234-273``,
sort :353-360).

A component implements ``comm_query(comm) -> (priority, module)|None``.
Selection queries every registered component, keeps priority >= 0, sorts
descending, and lets the caller compose winners (coll composes a
per-function vtable, taking the highest-priority provider per function).

Components can be disabled/forced via the MCA var
``<framework>_base_include`` (comma list, empty = all), mirroring the
reference's ``--mca coll basic,tuned`` selection syntax.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.mca import var


class Component:
    """Base class for components. Subclasses set ``name`` and implement
    ``comm_query``."""

    name: str = "base"
    framework: str = ""

    def register_params(self) -> None:
        """Called once at framework open; register MCA vars here."""

    def comm_query(self, comm) -> Optional[Tuple[int, Any]]:
        """Return (priority, module) if this component can serve ``comm``,
        else None. Priority < 0 also means 'not me'."""
        raise NotImplementedError


class Framework:
    def __init__(self, name: str):
        self.name = name
        self.components: Dict[str, Component] = {}
        self._opened = False

    def register(self, component: Component) -> Component:
        component.framework = self.name
        self.components[component.name] = component
        return component

    def open(self) -> None:
        if self._opened:
            return
        var.var_register(self.name, "base", "include", vtype="str", default="",
                         help=f"Comma list of {self.name} components to allow "
                              "(empty = all)")
        var.var_register(self.name, "base", "verbose", vtype="int", default=0,
                         help=f"Verbosity for the {self.name} framework")
        for c in self.components.values():
            c.register_params()
        self._opened = True

    def close(self) -> None:
        """Forget the open: the next ``open`` registers the vars again
        (and so re-reads the environment)."""
        self._opened = False

    def _allowed(self) -> List[Component]:
        include = var.var_get(f"{self.name}_base_include", "") or ""
        names = [n.strip() for n in include.split(",") if n.strip()]
        if not names:
            return list(self.components.values())
        return [c for n, c in self.components.items() if n in names]

    def comm_select(self, comm) -> List[Tuple[int, Component, Any]]:
        """Query all allowed components for ``comm``; return
        [(priority, component, module)] sorted by descending priority.
        Mirrors coll_base_comm_select.c:234-273 (+ sort at :353-360)."""
        self.open()
        avail: List[Tuple[int, Component, Any]] = []
        for c in self._allowed():
            res = c.comm_query(comm)
            if res is None:
                continue
            prio, module = res
            if prio < 0:
                continue
            avail.append((prio, c, module))
        # Stable sort, descending priority; tie-break on component name so
        # selection is deterministic across ranks.
        avail.sort(key=lambda t: (-t[0], t[1].name))
        return avail


_frameworks: Dict[str, Framework] = {}


def register_framework(name: str) -> Framework:
    fw = _frameworks.get(name)
    if fw is None:
        fw = Framework(name)
        _frameworks[name] = fw
    return fw


def get_framework(name: str) -> Framework:
    return _frameworks[name]


def all_frameworks() -> Dict[str, Framework]:
    return dict(_frameworks)
