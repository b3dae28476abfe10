"""The control comes out not correct: the plain reference in float32 with
TF32 matmuls, put in the program's place at a cell's own size, fails at
least one of the cell's limits on every seed tried, while the program on the
same samples passes them all. On the card only:

    python -m pytest --noconftest -p no:cacheprovider -m cuda vio_bench/tests/test_vb_control.py

(``--noconftest`` keeps the repository's tests/conftest.py, which imports
JAX, out; this folder's conftest has nothing this test needs.)"""

import json
from pathlib import Path

import pytest
import torch

from vio_bench import cell as C

REPO = Path(__file__).resolve().parents[2]
SEEDS = (2147483713, 3000000041, 4000000007)


def _cells():
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = C.Cell(REPO, workload)
    for seed in SEEDS:
        res = C.run(cell, seed, 2.0, False, device="cuda", log=lambda m: None, control=True)
        gaps, _ = res["control"]
        assert res["check"]["correct"], (seed, res["check"])
        assert any(gaps[k] > cell.limits[k] for k in cell.limits), (seed, gaps, cell.limits)
