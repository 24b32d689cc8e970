"""Trained images per second over the traced run's window times the plain
operation count of one image's G+D step with VGG19
(``counts.train_step_per_image``), over the card's published peak for the
configuration's arithmetic."""


def read(layers):
    return layers.mfu_pct()
