"""Device ms of the convolution kernels (cuDNN's, for every net) per
served image in the traced slice."""


def read(layers):
    return layers.per_slice_image_ms("conv")
