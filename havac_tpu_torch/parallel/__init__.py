"""Multi-device sweeps over ``torch.distributed``: the 1-D sequence wavefront.

The counterpart of `havac_tpu/parallel/`'s 1-D path. The database is cut
into D contiguous shards held by one or more processes
(:class:`~havac_tpu_torch.parallel.multihost.ShardMesh`); the models are cut
into row chunks that flow across the shards as a wavefront, one launch of
the sweep kernel per shard and step, with each launch's final carry as the
next shard's seam (:mod:`~havac_tpu_torch.parallel.wavefront`,
:mod:`~havac_tpu_torch.parallel.swar_dist`). ``Havac(mesh=...)`` runs it.
"""
