"""Multi-device sweeps over ``torch.distributed``: the sequence wavefront on a
1-D mesh, and model groups on a 2-D (sequence x model) one.

The counterpart of `havac_tpu/parallel/`. The database is cut into D_seq
contiguous shards held by one or more processes
(:class:`~havac_tpu_torch.parallel.multihost.ShardMesh`); the models are cut
into row chunks that flow across the shards as a wavefront, one launch of
the sweep kernel per shard and step, with each launch's final carry as the
next shard's seam (:mod:`~havac_tpu_torch.parallel.wavefront`,
:mod:`~havac_tpu_torch.parallel.swar_dist`). On a 2-D mesh the collection
is also cut into D_model groups of whole models, each running its own
wavefront down its column of shards with nothing exchanged between groups
(:mod:`~havac_tpu_torch.parallel.swar_dist2d`; model isolation required).
``Havac(mesh=...)`` runs either; :mod:`~havac_tpu_torch.parallel.dryrun`
checks both against the oracle.
"""
