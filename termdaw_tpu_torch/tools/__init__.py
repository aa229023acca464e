"""Scripts of the port: measurements on the card (scan_tiling,
shard_render) and the stream example's packet generator (stream_gen)."""
