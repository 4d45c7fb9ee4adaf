"""Scaling beyond one device.

The aligner is data-parallel over reads: the FM-index is replicated on
every card, chunks of reads are dealt to per-card backends (cli.py, through
runtime.run_pipeline), and the per-lane kernels need no collective.
Determinism comes from chunk-indexed output, not from communication.

Across hosts (or processes), each process aligns the chunks of its shard
(`--shard h:N`, multihost.run_sharded) on its own card and writes them as
chunk files, and `merge` concatenates them in chunk order.  mesh.py splits
one batch of reads over several devices for the fused seed-extend step.
"""
