"""The port's stage profiler (``lfvio_tpu_torch.runtime.profiling``).

* ``make_window_problem``: every tensor within 1e-12 of the JAX package's
  from the same seed (float64), the configuration equal.
* ``profile_solve``: the same stage rows as the JAX package's, in order,
  and every stage runs on the CPU with finite outputs (``time_stage`` is
  replaced by one plain call: timing needs the card; on the JAX side by
  nothing, which skips compiling the stages).
* ``time_stage`` and ``main`` refuse to time without a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvio_tpu.runtime import profiling as jprof
from lfvio_tpu_torch.runtime import profiling as tprof


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("kw", [dict(n_feat=24), dict(n_feat=16, n_obs_frames=4, seed=3),
                                dict(n_feat=8, with_prior=False, imu_samples=5)])
def test_make_window_problem_matches_jax(kw):
    j = jprof.make_window_problem(dtype=jnp.float64, **kw)
    t = tprof.make_window_problem(dtype=torch.float64, device="cpu", **kw)
    assert set(j) == set(t)
    for key in ("state", "grid", "prior"):
        for f in dataclasses.fields(j[key]):
            a, b = getattr(j[key], f.name), getattr(t[key], f.name)
            if a is None:
                assert b is None
                continue
            np.testing.assert_allclose(flat(b).astype(np.float64), np.asarray(a, np.float64),
                                       rtol=0, atol=1e-12, err_msg=f"{key}.{f.name}")
    for key in ("dts", "accs", "gyrs", "a0", "g0", "imu_valid", "gravity"):
        np.testing.assert_allclose(flat(t[key]), np.asarray(j[key]), rtol=0, atol=1e-12)
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])
    assert dataclasses.astuple(t["noise"]) == dataclasses.astuple(j["noise"])


def test_profile_solve_rows_match_jax(monkeypatch):
    t_outs = []

    def once(name, fn, args, n=20, chain_arg=None, note=""):
        t_outs.append(fn(*args))
        return tprof.StageTime(name, 0.0, 0.0, note)

    monkeypatch.setattr(jprof, "time_stage", lambda name, *a, note="", **k:
                        jprof.StageTime(name, 0.0, 0.0, note))
    monkeypatch.setattr(tprof, "time_stage", once)
    rows_j = jprof.profile_solve(8, max_iterations=2, dtype=jnp.float64, n=1)
    rows_t = tprof.profile_solve(8, max_iterations=2, dtype=torch.float64, n=1, device="cpu")
    assert [r.name for r in rows_t] == [r.name for r in rows_j]
    assert len(t_outs) == len(rows_t) == 9

    def finite(x):
        if isinstance(x, torch.Tensor):
            return bool(torch.isfinite(x.to(torch.float64)).all())
        if dataclasses.is_dataclass(x):
            return all(finite(getattr(x, f.name)) for f in dataclasses.fields(x)
                       if getattr(x, f.name) is not None)
        if isinstance(x, (tuple, list)):
            return all(finite(v) for v in x)
        return True

    assert all(finite(o) for o in t_outs)


def test_profile_frontend_runs_its_stages_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tprof, "time_stage",
                        lambda name, fn, args, n=20, chain_arg=None, note="":
                        tprof.StageTime(name, float(len(fn(*args))), 0.0))
    rows = tprof.profile_frontend(width=192, height=144, device="cpu")
    assert [r.name for r in rows] == ["preprocess alone (CLAHE + 4-level pyramid)",
                                      "tracker step (pre+LK+RANSAC+detect)"]
    assert rows[0].ms == 4 and rows[1].ms == 6  # pyramid levels; the step's outputs


def test_print_table(capsys):
    tprof.print_table([tprof.StageTime("lm_solve total (8 iters)", 812.25, 9.5),
                       tprof.StageTime("  total_cost (1x)", 3.0, 0.1, "host-bound")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["stage", "ms", "first", "s", "note"]
    assert lines[1].split()[-2:] == ["812.250", "9.50"] and lines[2].endswith("host-bound")


def test_timing_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.time_stage("x", lambda: None, ())
    with pytest.raises(SystemExit, match="no CUDA device"):
        tprof.main([])
