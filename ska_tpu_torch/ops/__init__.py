"""Device primitives of the port: packed-key ops, window extraction, the
bitonic sort and the merged build pipeline."""
