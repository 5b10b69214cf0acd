"""Multi-device paths over ``torch.distributed``, one process per card:
data-parallel training (``mesh``), batch-sharded sampling (``sample_shard``)
and column-sharded EGNN aggregation (``edge_shard``)."""
