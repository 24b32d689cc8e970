"""The attention forward's share of its roofline in the traced slice: the
least time its calls need on the card (S over the kept keys and P V over
all keys at the peak, or their bytes at the bandwidth) over the device
time of its ``ca_fwd`` kernels."""


def read(layers):
    return layers.roofline_pct(backward=False)
