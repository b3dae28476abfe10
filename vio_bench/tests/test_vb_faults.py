"""A run with the timed path broken underneath comes out not correct: the
harness driven on the CPU (its look for a card skipped) over the tiny
float64 cell, once sound and once with each fault of ``vio_bench.faults``
that a cell of this system can have."""

import pytest
import torch

from vio_bench import cell as C
from vio_bench import faults

SEED = 3000000019


def _run(root):
    torch.set_num_threads(4)
    cell = C.Cell(root, "tiny.kf")
    return C.run(cell, SEED, 0.3, False, device="cpu", log=lambda m: None)


def test_sound_run_is_correct(tiny_root):
    res = _run(tiny_root)
    assert res["check"]["correct"], res["check"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    caught_by = faults.FAULTS[fault][1]
    res = _run(tiny_root)
    chk = res["check"]
    assert not chk["correct"], chk
    assert chk["numbers"][caught_by]["value"] > chk["numbers"][caught_by]["limit"], chk
