"""BENCHMARK.json against the benchmark's contract, the limits of every cell,
and the schema of a run's last line."""

import json
import math
import re

import numpy as np

from vio_bench import cell as C
from vio_bench import run as R
from vio_bench.check import NUMBERS

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["vio_bench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vio_bench/") and (REPO / c["file"]).exists()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "vio_bench/traffic" / f"{w['traffic']}.json").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "vio_bench/metrics" / f"{m['name']}.py").exists()
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_has_real_limits():
    for w in _bench()["workloads"]:
        lim = json.loads((REPO / "vio_bench/limits" / f"{w['name']}.json").read_text())
        assert set(lim) == set(NUMBERS)
        assert all(math.isfinite(v) and 0 < v < 1e3 for v in lim.values()), w["name"]


def test_last_line_schema():
    cell = C.Cell(REPO, _bench()["workloads"][0]["name"])
    sl = dict(window_s=0.5, busy_s=0.4, kernels=90, frames=3, n_valid=[150, 150],
              by_name={"lk_pyramid_kernel": 3e-5, "k": 1e-3}, count={"lk_pyramid_kernel": 1, "k": 5},
              idle_by_host={"vio::feed_imu": 0.1})
    res = dict(window=dict(frames=30, wall_s=0.25, latencies_s=[0.04] * 20, failed=0, slice=sl),
               setup_s=10.0, lm_runs=[(8, 8, False)], memory_peak_bytes=123, cfg=cell.cfg,
               shapes=[(960, 1280), (480, 640), (240, 320), (120, 160)],
               spans_ms={"solve": [7.0], "marg_old": [1.0], "frontend_published": [2.0]},
               check=dict(correct=True, numbers={k: {"value": 1e-6, "limit": 1e-3} for k in NUMBERS}))
    for traced in (False, True):
        line = json.loads(json.dumps(R.result_line(cell, res, traced, "NVIDIA H100 80GB HBM3", 1)))
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        want = cell.per_layer if traced else cell.end_to_end
        assert set(line["metrics"]) == {m["name"] for m in want}
        for m in want:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
        if traced:
            assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
            assert len(line["breakdown"]["device_ops"]) <= 10
        else:
            assert "breakdown" not in line and "busy_s" not in line["device"]
    np.testing.assert_allclose(line["metrics"]["device_idle_pct"]["value"], 20.0)
