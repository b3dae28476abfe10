"""The port's keyframe-axis bundle adjustment (``lfvio_tpu_torch.dist.kf_axis``),
its synthetic problems (``dist/synthetic_traj.py``) and its scaling bench,
against the JAX package on the CPU, float64.

The solve's ranks are processes of their own (``tests/_torch_kf_child.py``:
gloo, ``file://`` rendezvous, 60 s timeouts); every run, the bench's
included, starts in one module fixture, beside the one call of the JAX
``segmented_trajectory_solve`` that tier-1 makes (about 150 s on an 8-core
CPU: the call is not jitted as a whole and compiles anew each time). Bounds,
relative to each quantity's largest magnitude (at least 1):

* synthetic problem, port against JAX: 1e-12;
* the helpers (_first15_selector, _idx15, _res15, _retract15, _marginal15):
  1e-10, the relative eigenvalue floor exercised by a negative and a
  near-null direction;
* the whole solve on a 3 × 1 grid (an interior segment that uses both
  messages) against JAX on the same problem, carried over with ``convert``:
  states, inverse depths, gaps, costs and history within 1e-7; the outputs
  identical on every rank;
* a 2 × 2 grid against 2 × 1 on one problem (only the order of the sums
  differs; covers the 1/√n_f scaling of the boundary terms): 1e-9.

Slow-marked, as tests/test_kf_axis.py is: 2 × 2 against JAX (1e-7), and that
file's own gate on the port (2 × 2 and 4 × 1 against the port's monolithic
``lm_solve``: gaps < 5e-3 m, poses within 1 cm, error to the truth below half
the initial perturbation). The small problem runs 3 LM iterations and 3
outer rounds (cost_tol 0); the gate 6 iterations and 2 + 3S rounds.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvio_tpu.backend.state import SolverConfig as JSolverConfig
from lfvio_tpu.dist import kf_axis as jkf
from lfvio_tpu.dist import synthetic_traj as jst
from lfvio_tpu.imu import ImuNoise as JImuNoise

from lfvio_tpu_torch.dist import kf_axis as tkf
from lfvio_tpu_torch.dist import synthetic_traj as tst
from tests import _torch_kf_child as child

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_KEYS = child.OUT_KEYS
BENCH = {"frame": ["16", "--shapes", "1,2"], "kf": ["--kf", "8", "--shapes", "1x1,2x1"]}


def close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def jax_problem(case):
    """The JAX package's problem of a case of the child, and its arrays."""
    S, _, Wseg, Fseg, _, _ = child.CASES[case]
    pb = jst.make_segmented_problem(S, Wseg, Fseg, jnp.float64, noise=child.BEARING_NOISE)
    arrays = {k: np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0", "imu_valid")}
    for tag in ("states", "grids", "priors"):
        for f, v in vars(pb[tag]).items():
            if v is not None:
                arrays[f"{tag}.{f}"] = np.asarray(v)
    return pb, arrays


def jax_solve(pb, case):
    S, n_f, _, _, iters, n_outer = child.CASES[case]
    cfg = JSolverConfig(max_iterations=iters, estimate_td=False, estimate_extrinsic=False,
                        cost_tol=0.0)
    states, gap, costs, hist = jkf.segmented_trajectory_solve(
        jkf.make_kf_mesh(S, n_f, jax.devices()[:S * n_f]), pb["states"], pb["grids"], pb["dts"],
        pb["accs"], pb["gyrs"], pb["a0"], pb["g0"], pb["imu_valid"], pb["priors"],
        JImuNoise(0.02, 0.01, 0.04, 0.001), cfg, g_norm=jst.G_NORM, n_outer=n_outer)
    out = {k: np.asarray(getattr(states, k)) for k in STATE_KEYS}
    out.update(gap=np.asarray(gap), costs=np.asarray(costs), hist=np.asarray(hist))
    return out


def start(root, name, case, path=None):
    """The ranks of one run of the child, started."""
    d = root / name
    d.mkdir()
    world = child.CASES[case][0] * child.CASES[case][1]
    extra = [] if path is None else [str(path)]
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_kf_child.py"), str(r), str(world),
         str(d / "init"), str(d / f"rank{r}.npz"), case, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(root, procs, timeout=600):
    """{run: [rank outputs]} once every rank has ended (each killed at the
    end regardless); a failed rank fails the collection with its log."""
    out = {}
    try:
        for name, ps in procs.items():
            for p in ps:
                log, _ = p.communicate(timeout=timeout)
                assert p.returncode == 0, (name, log[-3000:])
            out[name] = [dict(np.load(root / name / f"rank{r}.npz")) for r in range(len(ps))]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


@pytest.fixture(scope="module")
def jax_small():
    return jax_problem("small-3x1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_small):
    """The port's runs and the bench, started together, and beside them the
    JAX solve at 3 × 1: {run: [rank outputs]}, "jax": JAX's outputs,
    "bench": {kind: (exit code, stdout, stderr)}."""
    root = tmp_path_factory.mktemp("kf")
    np.savez(root / "jax-small-3x1.npz", **jax_small[1])
    procs = {"small-3x1": start(root, "small-3x1", "small-3x1", root / "jax-small-3x1.npz"),
             "small-2x2": start(root, "small-2x2", "small-2x2"),
             "small-2x1": start(root, "small-2x1", "small-2x1")}
    env = dict(os.environ, PYTHONPATH=REPO)
    bench = {kind: subprocess.Popen(
        [sys.executable, "-m", "lfvio_tpu_torch.dist.scaling_bench", *args, "--device", "cpu",
         "--reps", "1"], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for kind, args in BENCH.items()}
    try:
        ref = jax_solve(jax_small[0], "small-3x1")
        out = collect(root, procs)
        out["bench"] = {}
        for kind, p in bench.items():
            so, se = p.communicate(timeout=600)
            out["bench"][kind] = (p.returncode, so, se)
    finally:
        for p in bench.values():
            p.kill()
    out["jax"] = ref
    return out


def test_synthetic_trajectory_matches_jax():
    K = 16
    t, p, v, q = tst.make_traj(K)
    jt, jp, jv, jq = jst.make_traj(K)
    for a, b in ((t, jt), (p, jp), (v, jv), (q, jq)):
        close(b, a, 1e-12)
    for a, b in zip(tst.make_imu_buffers(p, v, q), jst.make_imu_buffers(jp, jv, jq)):
        close(b, a, 1e-12)
    pts = tst.seg_landmarks(p, 1, 5, 8)
    close(jst.seg_landmarks(jp, 1, 5, 8), pts, 1e-12)
    got = tst.bearings_for(pts, p[5:11], q[5:11], 0.3 / 160, np.random.default_rng(7))
    ref = jst.bearings_for(pts, jp[5:11], jq[5:11], 0.3 / 160, np.random.default_rng(7))
    close(ref, got, 1e-12)
    state = tst.make_state(p[:6], v[:6], q[:6], np.ones(8))
    pr = tst.anchor_prior(97, 6, {0: 300.0, 3: 0.3}, state)
    jpr = jst.anchor_prior(97, 6, {0: 300.0, 3: 0.3}, jst.make_state(jp[:6], jv[:6], jq[:6],
                                                                     np.ones(8)))
    for f, val in vars(jpr).items():
        close(val, getattr(pr, f).numpy(), 1e-12)


def test_segmented_problem_matches_jax(jax_small):
    got = tst.make_segmented_problem(3, 5, 8, noise=child.BEARING_NOISE, device="cpu")
    ref = jax_small[1]
    for k, val in ref.items():
        tag, _, f = k.partition(".")
        x = getattr(got[tag], f) if f else got[tag]
        close(val, x.numpy(), 1e-12)
    ref_pb = jax_small[0]
    for k in ("p_init", "v_init", "q_init"):
        close(ref_pb[k], got[k], 1e-12)
    for a, b in zip(ref_pb["truth"], got["truth"]):
        close(a, b, 1e-12)
    assert got["grids"].cam is None and got["states"].p.dtype == torch.float64


def test_kf_helpers_match_jax():
    rng = np.random.default_rng(5)
    W1 = 4
    D = 15 * W1 + 7
    np.testing.assert_array_equal(tkf._first15_selector(D, W1, torch.float64).numpy(),
                                  np.asarray(jkf._first15_selector(D, W1, jnp.float64)))
    for first in (True, False):
        np.testing.assert_array_equal(tkf._idx15(D, W1, first), jkf._idx15(D, W1, first))

    def summary():
        q = rng.standard_normal(4)
        return [rng.standard_normal(3), q / np.linalg.norm(q), *rng.standard_normal((3, 3))]

    a, z, dx = summary(), summary(), 0.3 * rng.standard_normal(15)
    t = lambda xs: tuple(torch.as_tensor(x) for x in xs)
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)
    close(jkf._res15(j(a), j(z)), tkf._res15(t(a), t(z)).numpy(), 1e-10)
    for r, g in zip(jkf._retract15(j(a), jnp.asarray(dx)),
                    tkf._retract15(t(a), torch.as_tensor(dx))):
        close(r, g.numpy(), 1e-10)

    # The boundary block decoupled from the rest with eigenvalues -1 (a
    # negative direction), 1e-14 (near-null) and 1..1e3: the relative floor
    # max(1e-9, 1e-6 · 1e3) lifts both; then a coupled, indefinite system.
    V, _ = np.linalg.qr(rng.standard_normal((15, 15)))
    w = np.concatenate([[-1.0, 1e-14], np.geomspace(1.0, 1e3, 13)])
    B = rng.standard_normal((D, D))
    H_dec = B @ B.T
    for first in (True, False):
        idx = jkf._idx15(D, W1, first)
        rest = np.setdiff1d(np.arange(D), idx)
        H = H_dec.copy()
        H[np.ix_(idx, rest)] = 0.0
        H[np.ix_(rest, idx)] = 0.0
        H[np.ix_(idx, idx)] = (V * w) @ V.T
        A = rng.standard_normal((D, D))
        for Hc in (H, H_dec + 0.5 * (A + A.T)):
            got = tkf._marginal15(torch.as_tensor(Hc), idx)
            ref = jkf._marginal15(jnp.asarray(Hc), idx, jnp.float64)
            for r, g in zip(ref, got):
                close(r, g.numpy(), 1e-10)
            if Hc is H:
                w_pd = np.linalg.eigvalsh(got[1].numpy())
                assert abs(w_pd[:2] - 1e-3).max() < 1e-9, w_pd


def test_kf_mesh_refuses_a_wrong_world_size(tmp_path):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="2x2 mesh needs 4 ranks, the process group has 1"):
            tkf.make_kf_mesh(2, 2)
        mesh = tkf.make_kf_mesh(1, 1)
        assert (mesh.n_kf, mesh.kf, mesh.row.rank, mesh.row.size) == (1, 0, 0, 1)
    finally:
        dist.destroy_process_group()


def check_ranks_agree(ranks):
    for other in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k])


def test_segmented_solve_matches_jax(runs):
    """3 × 1: segment 1 takes both neighbours' messages."""
    ranks, ref = runs["small-3x1"], runs["jax"]
    check_ranks_agree(ranks)
    got = ranks[0]
    for k in (*STATE_KEYS, "gap", "costs", "hist"):
        close(ref[k], got[k], 1e-7)
    # The interior segment's forward echo correction needs its right message.
    assert got["gap"][-1] == 0.0 and np.all(got["hist"][1, 1, 1:] > 0)


def test_f_axis_inside_a_row(runs):
    """2 × 2 against 2 × 1 on the port's own problem."""
    check_ranks_agree(runs["small-2x2"])
    check_ranks_agree(runs["small-2x1"])
    ref, got = runs["small-2x1"][0], runs["small-2x2"][0]
    for k in (*STATE_KEYS, "gap", "costs", "hist"):
        close(ref[k], got[k], 1e-9)


@pytest.mark.parametrize("kind,metric,key,rows", [
    ("frame", "sharded_frame_step_ms", "per_device_count", ["1", "2"]),
    ("kf", "kf_axis_round_ms", "segments_x_fshards", ["1x1", "2x1"]),
])
def test_scaling_bench_prints_the_jax_scripts_lines(runs, kind, metric, key, rows):
    rc, so, se = runs["bench"][kind]
    assert rc == 0, se[-3000:]
    line = json.loads(so.strip().splitlines()[-1])
    assert line["metric"] == metric and sorted(line[key]) == rows, line
    assert all(np.isfinite(v) and v > 0 for v in line[key].values()), line
    if kind == "frame":
        assert line["n_features"] == 16


@pytest.fixture(scope="module")
def slow_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kf-slow")
    pb, arrays = jax_problem("small-2x2")
    np.savez(root / "jax-small-2x2.npz", **arrays)
    procs = {"jax-2x2": start(root, "jax-2x2", "small-2x2", root / "jax-small-2x2.npz"),
             "gate-2x2": start(root, "gate-2x2", "gate-2x2"),
             "gate-4x1": start(root, "gate-4x1", "gate-4x1")}
    ref = jax_solve(pb, "small-2x2")
    out = collect(root, procs)
    out["jax"] = ref
    return out


@pytest.mark.slow
def test_segmented_solve_2x2_matches_jax(slow_runs):
    check_ranks_agree(slow_runs["jax-2x2"])
    for k in (*STATE_KEYS, "gap", "costs", "hist"):
        close(slow_runs["jax"][k], slow_runs["jax-2x2"][0][k], 1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["gate-2x2", "gate-4x1"])
def test_segmented_matches_monolithic(slow_runs, case):
    """tests/test_kf_axis.py's gate on the port."""
    S, _, Wseg, Fseg, _, _ = child.CASES[case]
    pb = tst.make_segmented_problem(S, Wseg, Fseg, noise=child.BEARING_NOISE, device="cpu")
    mono, c0, c1 = tst.solve_joint(pb, child.NOISE, child.solver_config(40))
    assert float(c1) < float(c0)
    got = slow_runs[case][0]
    out_p, mono_p, p = got["p"], mono.p.numpy(), pb["truth"][1]
    errs = [np.linalg.norm(out_p[s, j] - mono_p[s * Wseg + j])
            for s in range(S) for j in range(Wseg + 1)]
    truth = [np.linalg.norm(out_p[s, j] - p[s * Wseg + j])
             for s in range(S) for j in range(Wseg + 1)]
    assert np.isfinite(errs).all()
    assert got["gap"].max() < 5e-3, got["gap"]
    assert max(errs) < 0.01, (max(errs), np.mean(errs))
    assert max(truth) < 0.5 * np.linalg.norm(pb["p_init"] - p, axis=-1).max()
