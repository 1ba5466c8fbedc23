"""The mesh-sharded reliability layer: shard axes, per-shard streams and
counter folds, and the per-shard rail and KV scrub steps."""
