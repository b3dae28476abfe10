"""The port's relocalization rows (``backend/relo_cuda.py``: the analytic
rows ``relo_jacobian`` and the plain versions of ``relo_normal`` and
``relo_cost`` that the CPU runs; ``backend/relo.py::linearize_relo_rows``)
against the JAX package's forward-mode linearization, on the CPU in float64.

Each case feeds the same numpy inputs to one jitted JAX function
(``lfvio_tpu/backend/relo.py``'s ``linearize_relo_rows`` and the sums its
lm_solve_relo forms into the augmented [D+6] system, ``:192-202``) and to
the port. The bound is 1e-10 of each output's scale (its largest
magnitude, at least 1), as in ``tests/test_torch_proj_factor.py``.

The cases: tests/test_torch_estimator.py::relo_problem's window and loop
draws (32 slots, tracks of 5 frames from varied anchors, window frame 3
seen again from a pose a few centimetres off, 30% of the matches masked)
with the extrinsic estimated and not; and a two-camera window
(tests/test_torch_proj_factor.py::numpy_window) whose anchors lie on both
cameras, with |λ| below the clamp of 1e-8 (both signs), a point 10 km away
(λ = 1e-4), an unused slot and masked matches. Just above the clamp the
forward-mode λ column is the one that loses digits (its form cancels
terms depth / baseline times larger; at λ = 1.5e-8 it differs from the
analytic one by 1.6e-8 of a column of size 27), so the far point stays
where both are exact to 1e-10.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lfvio_tpu import backend as jb
from lfvio_tpu.backend import relo as jrelo
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch.backend import relo as trelo
from lfvio_tpu_torch.backend import relo_cuda

from test_torch_proj_factor import numpy_window

F64 = torch.float64
TOL = 1e-10
CASES = ("mono", "mono_ex_off", "dual")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max()) if a.size else 1.0)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * scale, (err, scale)
    return err


def mono_window(estimate_extrinsic):
    """relo_problem's window and loop draws (tests/test_torch_estimator.py)."""
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(5)
    s = pb["state"]
    state = dataclasses.replace(
        s, p=s.p + 0.02 * rng.standard_normal(s.p.shape), td=jnp.asarray(0.002),
        tic=jnp.asarray([0.01, -0.02, 0.005]))
    Fn = 32
    b = np.asarray(pb["grid"].bearing)[:, 3] + 3e-3 * rng.standard_normal((Fn, 3))
    mask = rng.random(Fn) < 0.7
    rp = np.asarray(state.p[3]) + 0.03 * rng.standard_normal(3)
    rq = np.asarray(state.q[3])
    cfg = jb.SolverConfig(max_iterations=8, estimate_extrinsic=estimate_extrinsic)
    return state, pb["grid"], cfg, (rp, rq, b, mask)


def dual_window():
    """numpy_window's two-camera window (40 slots, window 10: slots 0 and 1
    at |λ| < 1e-8, slot 2 unused), slot 3 moved to λ = 1e-4; the loop frame
    is window frame 4 seen again through camera 0 from a pose off the
    window's, with bearing noise; 20% of the matches masked, slots 0, 1 and
    3 matched."""
    c = numpy_window(3, 40, 11, 2)
    state = c["state"]
    lam = np.asarray(state.inv_depth).copy()
    lam[3] = 1e-4
    state = dataclasses.replace(state, inv_depth=jnp.asarray(lam))
    rng = np.random.default_rng(13)
    F = lam.shape[0]
    p, q = np.asarray(state.p), np.asarray(state.q)
    b = np.asarray(c["grid"].bearing)[:, 4] + 2e-3 * rng.standard_normal((F, 3))
    mask = rng.random(F) < 0.8
    mask[[0, 1, 3]] = True
    rp = p[4] + 0.05 * rng.standard_normal(3)
    rq = q[4] + 0.01 * rng.standard_normal(4)
    rq /= np.linalg.norm(rq)
    return state, c["grid"], c["cfg"], (rp, rq, b, mask)


def jax_relo(state, grid, rp, rq, b, mask, base, cfg):
    """JAX's relo rows and lm_solve_relo's augmented sums
    (lfvio_tpu/backend/relo.py:192-202) on the base system ``base`` =
    (H_pp, H_pl, H_ll, b_p, b_l)."""
    H_pp, H_pl, H_ll, b_p, b_l = base
    res_w, Jr, Jr_lam, valid, cost = jrelo.linearize_relo_rows(state, grid, rp, rq, b, mask, cfg)
    F, _, D6 = Jr.shape
    D = D6 - 6
    Jr_mat = Jr.reshape(F * 2, D6)
    H6 = jnp.zeros((D6, D6)).at[:D, :D].set(H_pp) + Jr_mat.T @ Jr_mat
    b6 = jnp.zeros((D6,)).at[:D].set(b_p) + Jr_mat.T @ res_w.reshape(F * 2)
    H_pl6 = jnp.zeros((D6, F)).at[:D, :].set(H_pl) + jnp.einsum("fad,fa->df", Jr, Jr_lam)
    H_ll6 = H_ll + jnp.einsum("fa,fa->f", Jr_lam, Jr_lam)
    b_l6 = b_l + jnp.einsum("fa,fa->f", Jr_lam, res_w)
    return (res_w, Jr, Jr_lam, valid, cost), (H6, H_pl6, H_ll6, b6, b_l6)


@pytest.fixture(scope="module", params=CASES)
def relo_case(request):
    """One case: its JAX outputs (one jitted function) and the port's inputs."""
    name = request.param
    state, grid, cfg, relo = mono_window(name == "mono") if name != "dual" else dual_window()
    F, W1 = np.asarray(grid.valid).shape
    C = 2 if name == "dual" else 1
    D = 15 * W1 + 6 * C + 1
    rng = np.random.default_rng(1)
    base = (rng.standard_normal((D, D)), rng.standard_normal((D, F)), rng.random(F) + 1.0,
            rng.standard_normal(D), rng.standard_normal(F))
    fn = jax.jit(lambda *a: jax_relo(*a, cfg))
    rows, system = fn(state, grid, *map(jnp.asarray, relo), tuple(map(jnp.asarray, base)))
    tcfg = convert.solver_config(dataclasses.asdict(cfg))
    trelo_args = (t(relo[0]), t(relo[1]), t(relo[2]), torch.as_tensor(relo[3]))
    return dict(name=name, rows=rows, system=system, base=base,
                t=(convert.window_state(fields(state)), convert.feature_grid(fields(grid)),
                   trelo_args, tcfg))


def test_cases_cover_what_they_claim(relo_case):
    """The two-camera case matches features anchored on camera 1 whose
    extrinsic columns carry the anchor side apart from camera 0's, and
    features at |λ| < 1e-8 and at λ = 1e-4; every case masks matches."""
    st, grid, (rp, rq, b, mask), cfg = relo_case["t"]
    valid = mask & grid.used
    assert bool((~mask).any()) and int(valid.sum()) >= 10
    if relo_case["name"] != "dual":
        return
    anchor_cam = grid.cam_index()[torch.arange(grid.anchor.shape[0]), grid.anchor]
    assert int((valid & (anchor_cam == 1)).sum()) >= 5 and int((valid & (anchor_cam == 0)).sum())
    assert bool(valid[[0, 1, 3]].all()) and not bool(grid.used[2])
    assert abs(float(st.inv_depth[0])) < 1e-8 and abs(float(st.inv_depth[1])) < 1e-8
    Jfull = trelo.linearize_relo_rows(st, grid, rp, rq, b, mask, cfg)[1]
    W1 = grid.valid.shape[1]
    ex1 = Jfull[..., 15 * W1 + 6:15 * W1 + 12]
    assert float(ex1[valid & (anchor_cam == 1)].abs().max()) > 0
    assert float(ex1[anchor_cam == 0].abs().max()) == 0.0


def test_relo_rows_match_jax(relo_case):
    """``linearize_relo_rows`` (res_w, Jfull [F, 2, D+6], J_lam, valid,
    cost) from the analytic rows against JAX's forward-mode ones."""
    st, grid, relo, cfg = relo_case["t"]
    ours = trelo.linearize_relo_rows(st, grid, *relo, cfg)
    ref = relo_case["rows"]
    assert ours[1].shape == ref[1].shape
    assert (np.asarray(ref[3]) == ours[3].numpy()).all()
    for i in (0, 1, 2, 4):
        close(ref[i], ours[i])


def test_relo_normal_plain_matches_jax(relo_case):
    """``relo_normal`` on CPU tensors (its plain version) adds the relo
    rows into a base system in place: equal to the augmented system JAX's
    lm_solve_relo forms from its rows and the same base."""
    st, grid, relo, cfg = relo_case["t"]
    H_pp, H_pl, H_ll, b_p, b_l = (t(x) for x in relo_case["base"])
    pad = torch.nn.functional.pad
    sums = (pad(H_pp, (0, 6, 0, 6)), pad(H_pl, (0, 0, 0, 6)), H_ll.clone(), pad(b_p, (0, 6)),
            b_l.clone())
    out = relo_cuda.relo_normal(*sums, st, grid, *relo, cfg)
    assert all(o is s for o, s in zip(out, sums))  # in place
    for ref, ours in zip(relo_case["system"], out):
        close(ref, ours)


def test_relo_cost_plain_matches_jax(relo_case):
    """``relo_cost`` on CPU tensors: its terms' half-sum equals JAX's relo
    cost, and each term the cost term of ``relo_jacobian``'s row."""
    st, grid, relo, cfg = relo_case["t"]
    terms = relo_cuda.relo_cost(st, grid, *relo, cfg)
    close(relo_case["rows"][4], 0.5 * terms.sum())
    close(relo_cuda.relo_jacobian(st, grid, *relo, cfg)[4], terms, 1e-14)
    valid = relo[3] & grid.used
    assert bool((terms[~valid] == 0).all()) and bool((terms[valid] > 0).all())


def test_lm_solve_relo_runs_no_forward_ad():
    """``lm_solve_relo`` under torch.profiler launches no forward-mode
    autodiff op: its relo rows are analytic."""
    from lfvio_tpu_torch import imu as timu
    from lfvio_tpu_torch.runtime.profiling import make_window_problem as tproblem

    from test_torch_imu_factor import FORWARD_AD_OPS

    pb = tproblem(16, F64, n_obs_frames=5, device="cpu")
    st = pb["state"]
    imu = [torch.as_tensor(pb[k], dtype=F64) for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = timu.preintegrate(*imu, st.ba[:-1], st.bg[:-1], pb["noise"])
    si, ok = timu.whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"]))
    rng = np.random.default_rng(2)
    b = pb["grid"].bearing[:, 3] + 3e-3 * torch.as_tensor(rng.standard_normal((16, 3)))
    cfg = dataclasses.replace(pb["cfg"], max_iterations=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = trelo.lm_solve_relo(st, pb["grid"], pre, si, ok, pb["prior"], pb["gravity"], cfg,
                                  st.p[3] + 0.02, st.q[3], b, torch.ones(16, dtype=torch.bool))
    names = {e.name for e in prof.events()}
    assert "aten::linalg_cholesky_ex" in names
    assert not names & set(FORWARD_AD_OPS), sorted(names & set(FORWARD_AD_OPS))
    assert float(out[4]) < float(out[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cams", [1, 2])
def test_relo_check_rejects_planted_faults(dtype, n_cams):
    """chip_smoke's check of the relo kernels, run on the CPU (where the
    wrappers are their plain versions) on its relo window: the plain version
    passes it, a repeat is identical, and each planted fault (a zero cost, a
    dropped match, and on two cameras the loop side's extrinsic block put in
    the anchor camera's columns) exceeds RELO_BOUNDS on the outputs that
    must reject it."""
    import chip_smoke

    args = chip_smoke.relo_window(torch.device("cpu"), dtype, n_cams)
    bound = chip_smoke.RELO_BOUNDS[str(dtype).split(".")[-1]]
    errs, _, identical = chip_smoke.relo_compare(args)
    assert identical
    assert max(errs.values()) <= bound, errs
    faults = chip_smoke.relo_planted_faults(args)
    want = set(chip_smoke.RELO_FAULT_OUTPUTS) - ({"loop side in the anchor camera's columns"}
                                                 if n_cams == 1 else set())
    assert set(faults) == want
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.RELO_FAULT_OUTPUTS[fault]), (fault, fe)
