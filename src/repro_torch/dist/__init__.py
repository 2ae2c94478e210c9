"""Distribution plumbing: the logical-axis sharding rules over a
``torch.distributed`` device mesh (:mod:`.sharding`), and the
collectives, both the stacked one-device shards of the sharded index and
the process-group family by logical axis, with the dry-run's fake world
(:mod:`.collectives`)."""
