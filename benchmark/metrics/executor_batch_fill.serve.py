"""Rows answered over rows the executor could have filled (max_batch per
batch), over the window's batches: ``server/executor.py`` counters."""


def read(layers):
    batches = layers.get("batches")
    if not batches:
        return None
    return 100.0 * layers.get("served") / (batches * layers.get("max_batch"))
