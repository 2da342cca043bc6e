"""btl — the byte-transfer layer of the per-rank tier: ``tcp`` (framed
sockets), ``sm`` (shared-memory rings), ``bml`` (their per-peer
multiplexer, which keeps each sender's frames in order) and ``devxfer``
(large device payloads through IPC handles)."""
