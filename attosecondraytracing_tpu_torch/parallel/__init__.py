"""Scale-out: shard meshes, sharded kernel passes, batched parameter scans."""
