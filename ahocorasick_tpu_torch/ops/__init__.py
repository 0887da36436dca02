"""Device engines of the port: the bit-parallel scan and its helpers."""
