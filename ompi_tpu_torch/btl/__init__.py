"""btl — the byte-transfer layer of the per-rank tier: ``tcp`` (framed
sockets), ``sm`` (shared-memory rings), ``bml`` (their per-peer
multiplexer, which keeps each sender's frames in order and stripes
large-message segments over rails), ``devxfer`` (large device payloads
through IPC handles) and ``shmseg`` (zero-copy shared-memory segments)."""
