"""Fixtures of the benchmark's own tests: a tiny cell (320×240, 48 slots,
float64, a 6 s period) in a checkout of its own, for runs on the CPU."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from vio_bench import cell as C
from vio_bench.check import NUMBERS

REPO = Path(__file__).resolve().parents[2]
# A float64 program against the float64 reference reads ~1e-9 and less; a
# planted fault reads 1e-4 and more. The shares of slots: RANSAC's
# rejections and LK's thresholds for the status; the feature manager's
# slots, full on this small cell, for the packing; a fault that halves
# either reads about a half.
TINY_LIMITS = dict({k: 1e-6 for k in NUMBERS}, status_gap=0.2, pack_gap=0.2)


def write_tiny(root: Path, limits=TINY_LIMITS):
    """A checkout at ``root`` with one cell, ``tiny.kf``: the mindvision rig
    scaled to 320×240 (the PAL polynomial rescaled as the port's synthetic
    camera is), float64, kf_replay's motion with a 6 s period. Returns root."""
    pkg = root / "vio_bench"
    for d in ("configs", "traffic", "limits"):
        (pkg / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "vio_bench" / "metrics", pkg / "metrics", dirs_exist_ok=True)
    cfg = json.loads((REPO / "vio_bench/configs/pal_mindvision.json").read_text())
    s = 0.25
    cfg["camera"].update(width=320, height=240, inv_poly_max_rho=130.0,
                         poly=list(np.asarray(cfg["camera"]["poly"]) / s ** np.arange(5)))
    cfg.update(n_slots=48, max_cnt=48, min_dist=10, annulus=[475 * s, 160 * s],
               precision="float64")
    (pkg / "configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / "vio_bench/traffic/kf_replay.json").read_text())
    tr.update(period_s=6.0, pos_cycles=[2, 1, 2], rot_cycles=[1, 1, 1])
    (pkg / "traffic/tiny_kf.json").write_text(json.dumps(tr))
    (pkg / "limits/tiny.kf.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file="vio_bench/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="tiny.kf", config="tiny",
                               traffic="tiny_kf")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """The tiny cell's checkout, with a fifth of a period of warm-up and a
    check that follows two frames and two solves."""
    monkeypatch.setattr(C, "WARMUP_PERIODS", 0.2)
    monkeypatch.setattr(C, "SAMPLE_FRAMES", 2)
    monkeypatch.setattr(C, "SAMPLE_SOLVES", 2)
    return write_tiny(tmp_path)
