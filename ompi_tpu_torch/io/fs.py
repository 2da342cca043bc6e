"""fs framework — filesystem glue (mirrors ``ompi/mca/fs``; the port of
``ompi_tpu/io/fs.py``).

The reference selects a component per file from the mounted filesystem
type (ufs default; lustre/gpfs/ime for parallel filesystems, each with
its own open/resize semantics — e.g. Lustre striping hints). Here
components carry the same query-by-path boundary: the mount table names
the filesystem type, each component claims the types it serves, and ufs
is the always-available fallback — so a Lustre-aware component drops in
without touching the file layer.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component, register_framework

fs_framework = register_framework("fs")


def _mount_fstype(path: str) -> str:
    """Filesystem type of the mount holding ``path`` (from the mount
    table — the role of the reference's statfs magic checks)."""
    def _unescape(p: str) -> str:
        # /proc/mounts octal-escapes space/tab/newline/backslash
        for esc, ch in (("\\040", " "), ("\\011", "\t"),
                        ("\\012", "\n"), ("\\134", "\\")):
            p = p.replace(esc, ch)
        return p

    try:
        best, fstype = "", ""
        real = os.path.realpath(path)
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = _unescape(parts[1])
                # path-component boundary: /mnt/lustre must not claim
                # /mnt/lustrebackup
                if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, fstype = mnt, parts[2]
        return fstype
    except OSError:
        return ""


class FsModule:
    """Per-file fs operations (open/resize/sync)."""

    name = "ufs"

    def open(self, path: str, amode: int) -> int:
        return os.open(path, amode, 0o644)

    def resize(self, fd: int, nbytes: int) -> None:
        os.ftruncate(fd, nbytes)

    def sync(self, fd: int) -> None:
        os.fsync(fd)

    def delete(self, path: str) -> None:
        os.unlink(path)


class UfsComponent(Component):
    """Generic Unix filesystem (``ompi/mca/fs/ufs``) — serves any type."""

    name = "ufs"

    def register_params(self) -> None:
        var.var_register("fs", "ufs", "priority", vtype="int", default=10,
                         help="Selection priority of the generic Unix fs")

    def file_query(self, path: str, fstype: str
                   ) -> Optional[Tuple[int, FsModule]]:
        return (var.var_get("fs_ufs_priority", 10), FsModule())

    def comm_query(self, comm):                 # fs selects per file
        return None


class _ParallelFsComponent(Component):
    """Base for parallel-fs components: claims only its fstype(s) at a
    priority above ufs (the reference's lustre/gpfs pattern)."""

    fstypes: Tuple[str, ...] = ()

    def file_query(self, path: str, fstype: str
                   ) -> Optional[Tuple[int, FsModule]]:
        if fstype not in self.fstypes:
            return None
        m = FsModule()
        m.name = self.name
        return (50, m)

    def comm_query(self, comm):
        return None


class LustreComponent(_ParallelFsComponent):
    name = "lustre"
    fstypes = ("lustre",)


class GpfsComponent(_ParallelFsComponent):
    name = "gpfs"
    fstypes = ("gpfs",)


fs_framework.register(UfsComponent())
fs_framework.register(LustreComponent())
fs_framework.register(GpfsComponent())


def select_fs(path: str) -> FsModule:
    """Pick the highest-priority fs module for ``path`` (the per-file
    analogue of comm_select)."""
    fs_framework.open()
    fstype = _mount_fstype(path)
    best: Optional[Tuple[int, FsModule]] = None
    # honor fs_base_include like every comm-scoped framework does
    for comp in fs_framework._allowed():
        res = comp.file_query(path, fstype)
        if res is not None and (best is None or res[0] > best[0]):
            best = res
    if best is None:                 # include list excluded even ufs
        return FsModule()
    return best[1]
