"""The harness finds a configuration, a traffic mix, the limits and a
metric by name, in files dropped into a checkout of its own: nothing in the
harness names a cell."""

import json

from vio_bench import cell as C

from conftest import write_tiny


def test_files_found_by_name(tmp_path):
    root = write_tiny(tmp_path)
    (root / "vio_bench/metrics/twice_the_rate.py").write_text(
        "def read(run):\n    return 2 * run['window']['frames'] / run['window']['wall_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "twice_the_rate", "unit": "frames/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = C.Cell(root, "tiny.kf")
    assert cell.cfg["camera"]["width"] == 320 and cell.traffic["period_s"] == 6.0
    assert cell.limits["prior_gap"] == 1e-6 and cell.limits["pack_gap"] == 0.2
    assert "twice_the_rate" in [m["name"] for m in cell.end_to_end]
    run = dict(window=dict(frames=30, wall_s=0.5, latencies_s=[0.01], slice={}), setup_s=1.0)
    got = C.read_metrics(cell, run, traced=False)
    assert got["twice_the_rate"] == {"value": 120.0, "unit": "frames/s"}
    assert got["frames_per_s"]["value"] == 60.0
