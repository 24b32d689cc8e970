"""The joint backward's share of its roofline in the traced slice: the
least time dQ, dK and dV need (dV over every key, dP, dQ and dK over the
kept keys, at the peak, or their bytes at the bandwidth) over the device
time of its ``ca_dq`` and ``ca_dkdv`` kernels."""


def read(layers):
    return layers.roofline_pct(backward=True)
