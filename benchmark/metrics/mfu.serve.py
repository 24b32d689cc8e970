"""Edits per second over the traced run's window times the plain
operation count of one edit (``counts.edit``), over the card's published
peak for the configuration's arithmetic."""


def read(layers):
    return layers.mfu_pct()
