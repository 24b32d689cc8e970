"""Device kernels per training step in the traced slice: the host
dispatch the step pays for."""


def read(layers):
    steps = layers.get("slice_steps")
    if layers.trace is None or not steps:
        return None
    return layers.trace.kernels / steps
