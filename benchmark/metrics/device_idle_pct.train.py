"""Share of the traced slice in which no kernel, copy or fill ran on the
card."""


def read(layers):
    return layers.idle_pct()
