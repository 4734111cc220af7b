"""Distributed runtime: the paper's Spark layer, on ``torch.distributed``.

HAlign-II delegates distribution to Spark: sequences become an RDD of
shards, map(1) aligns each shard against the broadcast center, reduce(1)
merges insert-space profiles, map(2) re-emits rows in the merged frame,
and Spark supplies checkpointing, replication, and straggler recovery.
This package is that layer for a world of ranks, one process each (the
reference's is a JAX mesh under one controller); every module of the
reference's ``repro.dist`` is ported:

  sharding.py          the ``Mesh`` over the ranks + named-axis helpers
                       (this rank's rows, broadcast, MAX, gather)
  mapreduce.py         the map/reduce over sequence shards (Fig. 3) and
                       the tree- and search-stage hooks
  collectives.py       overlap-friendly collectives (ring all-gather,
                       all-gather/matmul, reduce-scatter mean)
  grad_compression.py  int8 quantized psum-mean with error feedback
  checkpoint.py        atomic checkpoints with retention
  fault.py             shard replication plan + failure-replay step loop

Everything here runs unchanged in one process (a world of one), in
``gloo`` worlds on the CPU (the tests), or one rank a card.
"""
from . import (checkpoint, collectives, fault, grad_compression, mapreduce,
               sharding)

__all__ = ["checkpoint", "collectives", "fault", "grad_compression",
           "mapreduce", "sharding"]
