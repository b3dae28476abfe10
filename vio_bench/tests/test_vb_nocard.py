"""Without a card a run fails rather than falling back to the CPU, and the
import checks compare whole top-level names."""

import ast
import sys
from pathlib import Path

import pytest
import torch

from vio_bench import run as R

from conftest import REPO


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    rc = R.main(["--workload", "mindvision.kf", "--seed", "2147483659", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.chdir(REPO)
    rc = R.main(["--workload", "mindvision.kf", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_names_compared_whole():
    names = ["lfvio_tpu_torch", "lfvio_tpu_torch.device", "jaxtyping", "numpy"]
    assert R.forbidden_modules(names) == []
    assert R.forbidden_modules(names + ["jax.numpy", "lfvio_tpu.cam"]) == ["jax.numpy",
                                                                          "lfvio_tpu.cam"]


def test_reference_leaks_found():
    import types

    ref = types.ModuleType("vio_bench.reference.fake")
    ref.ok = np_like = types.ModuleType("numpy")
    ref.bad = types.ModuleType("lfvio_tpu_torch.device")
    other = types.ModuleType("vio_bench.cell")
    other.fine = ref.bad
    assert R.reference_leaks({"vio_bench.reference.fake": ref, "vio_bench.cell": other}) == [
        "vio_bench.reference.fake.bad"]
    assert np_like.__name__ == "numpy"
    import vio_bench.check  # noqa: F401  (the real reference, loaded beside the port)
    import lfvio_tpu_torch.device  # noqa: F401
    assert R.reference_leaks() == []


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "vio_bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_anywhere_and_no_port_in_the_reference(path):
    forbidden = set(R.FORBIDDEN)
    if "reference" in path.parts or path.name in ("world.py", "check.py"):
        forbidden.add("lfvio_tpu_torch")
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & forbidden, tops & forbidden


def test_reference_loads_nothing_of_the_port():
    """The reference, imported in a process of its own, pulls in no module of
    the port, of JAX or of the JAX package."""
    import subprocess

    code = ("import sys; import vio_bench.check, vio_bench.world; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "lfvio_tpu", "lfvio_tpu_torch"}
