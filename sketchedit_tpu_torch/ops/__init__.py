"""Layer primitives of the port (NCHW): gated convs, image ops, attention."""
