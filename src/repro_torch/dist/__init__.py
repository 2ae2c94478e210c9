"""Document-partition plumbing for the sharded index: the mesh of
stacked shards and its collectives (:mod:`.collectives`)."""
