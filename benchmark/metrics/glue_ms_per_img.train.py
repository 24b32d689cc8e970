"""Device ms of every kernel that is neither a convolution, an attention
kernel nor the optimizer (gating, activations, concatenation, losses,
casts) per trained image in the traced slice."""


def read(layers):
    return layers.per_slice_image_ms("other")
