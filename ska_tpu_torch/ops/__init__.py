"""Device primitives of the port: packed-key ops, window extraction, the
radix sort and the merged build pipeline, and host key helpers."""
