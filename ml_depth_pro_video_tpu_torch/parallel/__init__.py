"""Inference across ranks on ``torch.distributed`` (twin of the JAX package's ``parallel/``).

One process per rank, each rank on one device: ``multihost`` joins the
group and carries host objects, ``mesh`` lays ranks out as (dp, tp),
``spmd`` runs a per-frame program on each rank's rows, ``latency`` splits
one frame's forward over every rank. The training half (the JAX package's
``sharding`` and ``pipeline``) is not ported yet.
"""
