"""Scripts of the port: measurements on the card (scan_tiling,
shard_render), the parity report against the float64 oracle
(parity_report) and the stream example's packet generator (stream_gen)."""
