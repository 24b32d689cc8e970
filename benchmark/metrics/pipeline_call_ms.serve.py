"""Median wall time of one ``runner.EditPipeline`` call (host and device,
a whole batch), from the benchmark's span around the pipeline it hands the
executor, over the window's batches."""

import statistics


def read(layers):
    spans = layers.get("pipeline_ms")
    return statistics.median(spans) if spans else None
