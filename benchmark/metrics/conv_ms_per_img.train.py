"""Device ms of the convolution kernels (forward and both backward
passes, netM, netG, netD and VGG19) per trained image in the traced
slice."""


def read(layers):
    return layers.per_slice_image_ms("conv")
