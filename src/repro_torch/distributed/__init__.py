"""The multi-device layer: the sharding rules and placement, the
collectives of a process group with the int8-compressed data-parallel step,
and the mesh-sharded reliability layer (shard axes, per-shard streams and
counter folds, the per-shard rail and KV scrub steps)."""
