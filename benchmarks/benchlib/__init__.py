"""The benchmark's own library: the yardstick that later changes to the
program do not touch (spec lookup, traffic generation, least-byte
arithmetic, the profiler reduction, peaks and the comparison)."""
