"""The check must refuse what is not the program's sound output.

Each test drives the rest of a run on the CPU at 64^2 (the harness's look
for a card skipped) with the timed path broken underneath, and sees
``correct`` come out false under the cell's own limits: the control (the
reference in float8, put in the program's place), an answer altered where
it is produced, a training step that leaves its state unchanged, and one
that leaves half of the batch out. The control's readings at the cells'
own sizes come from ``calibrate.py`` on the GPU (PERF.md).
"""

from __future__ import annotations

import pytest
import torch

from benchmark import run

SERVE = {"clients": 4, "max_batch": 2, "pool": 8, "sample": 6,
         "check_block": 6, "trace_batches": 0}
TRAIN = {"batch": 2, "pool": 4, "trace_steps": 0}
SMALL = {"resolution": 64}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell,kwargs", [
    ("celeb256.serve_c64", {"program": "control"}),
    ("celeb256.serve_c64", {"fault": "altered_answer"}),
    ("places512.serve_c16", {"program": "control"}),
    ("places512.train_b8", {"program": "control"}),
    ("places512.train_b8", {"fault": "unchanged"}),
    ("places512.train_b8", {"fault": "half_batch"}),
], ids=["serve256-control", "serve256-altered", "serve512-control",
        "train-control", "train-unchanged", "train-half-batch"])
def test_broken_path_is_not_correct(cell, kwargs):
    over = SERVE if "serve" in cell else TRAIN
    result = run.run_cell(cell, 20231, 1.5, False, device="cpu",
                          config_overrides=SMALL, workload_overrides=over,
                          **kwargs)
    failing = [k for k, c in result["checks"].items()
               if c["value"] > c["limit"]]
    assert result["correct"] is False and failing, result["checks"]


@pytest.mark.gpu
def test_cell_runs_correct_on_the_gpu(cuda):
    """One short run of the 256^2 serving cell on the card, correct."""
    result = run.run_cell("celeb256.serve_c64", 777, 3.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
