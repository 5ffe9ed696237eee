"""Training across devices: the (data, shard) mesh and the tile-sharded step."""
