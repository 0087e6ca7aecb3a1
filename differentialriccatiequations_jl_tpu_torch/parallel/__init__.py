"""Row sharding and multi-rank execution over `torch.distributed` (port of
the JAX package's ``parallel/``): a 1-D `DeviceMesh` (`mesh.make_mesh`),
row shards of operators and factors (`mesh.shard_*`), the row-sharded DIA
and block-ELL products with a halo exchange (`sharded_ops`), and the
multi-rank dry run (`dryrun.dryrun_multichip`)."""
