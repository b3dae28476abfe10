"""The estimator's device programs in the JAX form, on the CPU in f64.

* ``backend/solver.py::lm_loop``: the fixed-count loop with every decision
  on the device, against the JAX package's ``lm_loop`` on
  ``tests/test_torch_backend.py::problem``'s window: iteration caps 1, 3
  and 8, a cost-plateau exit and a forced non-finite step; states within
  1e-10 of their scale.
* The packed upload: the layout's names, shapes and size equal the JAX
  ``Estimator._build_pack_layout`` for a mono and a two-camera rig, the
  packed buffer equals the JAX one from the same mirrors, and unpacking
  gives the mirrors back.
* ``frontend/ransac.py::_solve_E`` (eigh, then the rank-2 projection by a
  second eigh) against the JAX package's (eigh, then svd): up to sign,
  within 1e-9.
* The programs read nothing back: a stream through the estimator, with
  every program (solve, relocalization solve, both marginalizations) and
  the front end's published-frame step run under a dispatch mode that
  fails on any op that reads the device on the host or copies host data in
  on the card (what a CUDA graph cannot hold).

On the CPU ``device.DeviceProgram`` calls each program as it is, so the
existing stream tests (``tests/test_torch_estimator.py``,
``tests/test_torch_lag.py``) run the same programs eagerly.
"""

import contextlib
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lfvio_tpu.backend import solver as jsolver
from lfvio_tpu.frontend import ransac as jransac
from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig

from lfvio_tpu_torch import device as tdevice
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.frontend import ransac as transac
from lfvio_tpu_torch.geom import eigh_cuda
from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.pipeline import VioPipeline

from _torch_bearing_harness import BearingFrontEnd, cam_bearings, make_landmarks, run_stream
from test_torch_backend import close, problem  # noqa: F401  (the fixture)

F64 = torch.float64
STATE_FIELDS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


# ------------------------------------------------------------------ lm_loop
def _jax_fns(problem, nan_below=None):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    F, W1 = grid.valid.shape
    D = jsolver.pose_dim(W1, 1)

    def lin_fn(s, zeros_like=False):
        if zeros_like:
            z = jnp.zeros
            return (z((D, D)), z((D, F)), z((F,)), z((D,)), z((F,)))
        return jsolver.assemble_normal_equations(s, grid, pre, si, iv, prior, g, cfg)[:5]

    def solve_fn(lin, lam):
        dx, dlam = jsolver._schur_solve(*lin, lam, grid.used, jnp.float64)
        if nan_below is not None:
            dx = jnp.where(lam < nan_below, jnp.nan, dx)
        return dx, dlam

    def cost_fn(s):
        return jsolver.total_cost(s, grid, pre, si, iv, prior, g, cfg)

    return lin_fn, solve_fn, cost_fn


def _torch_fns(problem, nan_below=None):
    st, grid, pre, si, iv, prior, g, cfg = problem["t"]

    def lin_fn(s):
        return tsolver.assemble_normal_equations(s, grid, pre, si, iv, prior, g, cfg)[:5]

    def solve_fn(lin, lam):
        dx, dlam = tsolver._schur_solve(*lin, lam, grid.used)
        if nan_below is not None:
            dx = torch.where(lam < nan_below, torch.nan, dx)
        return dx, dlam

    def cost_fn(s):
        return tsolver.total_cost(s, grid, pre, si, iv, prior, g, cfg)

    return lin_fn, solve_fn, cost_fn


def _compare_loops(problem, caps, cost_tol=None, nan_below=None):
    """Both loops at each cap: states within 1e-10, costs and the history
    within 1e-10 of their scale. Returns the port's histories."""
    jst, jcfg = problem["j"][0], problem["j"][-1]
    tst, tcfg = problem["t"][0], problem["t"][-1]
    if cost_tol is not None:
        jcfg = dataclasses.replace(jcfg, cost_tol=cost_tol)
        tcfg = dataclasses.replace(tcfg, cost_tol=cost_tol)
    jfns = _jax_fns(problem, nan_below)
    loop = jax.jit(lambda s, cap: jsolver.lm_loop(s, *jfns, jcfg, cap))
    hists = {}
    for cap in caps:
        jout, jc0, jc1, jhist = loop(jst, jnp.asarray(cap, jnp.int32))
        tout, tc0, tc1, thist = tsolver.lm_loop(tst, *_torch_fns(problem, nan_below), tcfg,
                                                max_iter_dyn=cap)
        assert thist.shape == (cap,)
        close(jc0, tc0, 1e-10)
        close(jc1, tc1, 1e-10)
        close(np.asarray(jhist)[:cap], thist, 1e-10)
        for name in STATE_FIELDS:
            close(getattr(jout, name), getattr(tout, name), 1e-10)
        hists[cap] = thist.numpy()
    return hists


def test_lm_loop_caps_match_jax(problem):
    """Caps 1, 3 and 8 (the loop's length; JAX masks the rest of its scan)."""
    hists = _compare_loops(problem, (1, 3, 8))
    assert hists[8][-1] < hists[1][0]


def test_lm_loop_cost_plateau_exit_matches_jax(problem):
    """A loose cost_tol ends the loop early: the iterations after ``done``
    change nothing, as the JAX scan's skipped steps do."""
    hist = _compare_loops(problem, (8,), cost_tol=0.3)[8]
    assert hist[-1] == hist[-2] == hist[-3]


def test_lm_loop_non_finite_step_matches_jax(problem):
    """A step that is non-finite while the damping is below 1e-3 (the first
    two iterations, from 1e-4 and 8e-4) is zeroed and rejected; the damping
    grows and the loop goes on."""
    hist = _compare_loops(problem, (5,), nan_below=1e-3)[5]
    c0 = tsolver.total_cost(*[problem["t"][i] for i in (0, 1, 2, 3, 4, 5, 6, 7)])
    assert hist[0] == hist[1] == float(c0) and hist[-1] < hist[1]


def test_lm_solve_limit_masks_like_the_packed_max_iter(problem):
    """The in-program limit (the packed max_iter) masks iterations at and
    after it: limit 3 in a loop of 8 gives the 3-iteration states."""
    st, grid, pre, si, iv, prior, g, cfg = problem["t"]
    a = tsolver.lm_solve(st, grid, pre, si, iv, prior, g, cfg, max_iter_dyn=3)
    b = tsolver.lm_solve(st, grid, pre, si, iv, prior, g, cfg,
                         limit=torch.tensor(3, dtype=torch.int32))
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a[0], name), getattr(b[0], name))
    assert torch.equal(b[3][3:], b[3][2].expand(5))


# ------------------------------------------------------------- pack layout
def _seed(est, rng_seed, n_cams):
    rng = np.random.default_rng(rng_seed)
    W1, Fn = est.NF, est.cfg.n_feature_slots
    q = rng.standard_normal((W1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    est.frame_count, est.solver_flag = est.WIN, est.NON_LINEAR
    est.Ps, est.Qs = rng.standard_normal((W1, 3)), q
    est.Vs, est.Bas = rng.standard_normal((W1, 3)), 0.05 * rng.standard_normal((W1, 3))
    est.Bgs = 0.01 * rng.standard_normal((W1, 3))
    est._imu_dts[:] = 0.005
    est._imu_accs[:] = rng.standard_normal(est._imu_accs.shape)
    est._imu_gyrs[:] = rng.standard_normal(est._imu_gyrs.shape)
    est._imu_a0[:] = rng.standard_normal((W1, 3))
    est._imu_g0[:] = rng.standard_normal((W1, 3))
    est._imu_n[:] = rng.integers(0, 5, W1)
    est._imu_sumdt[:] = rng.uniform(0, 0.2, W1)
    est.td = 0.004
    fm = est.fm
    fm.feature_id[:] = np.arange(Fn) + 100
    fm.anchor[:] = rng.integers(0, 3, Fn)
    fm.depth[:] = np.where(rng.random(Fn) < 0.5, rng.uniform(2, 6, Fn), -1.0)
    fm.valid[:] = rng.random((Fn, W1)) < 0.6
    fm.bearing[:] = rng.standard_normal(fm.bearing.shape)
    fm.velocity[:] = rng.standard_normal(fm.velocity.shape)
    fm.td_obs[:] = rng.uniform(0, 0.01, fm.td_obs.shape)
    if n_cams > 1:
        fm.cam[:] = rng.integers(0, n_cams, fm.cam.shape)
    relo = dict(p=rng.standard_normal(3), q=q[0], bearing=rng.standard_normal((Fn, 3)),
                mask=rng.random(Fn) < 0.3)
    return relo


@pytest.mark.parametrize("n_cams", [1, 2])
def test_pack_layout_matches_jax_and_round_trips(n_cams):
    kw = dict(window=5, n_feature_slots=12, max_imu_per_interval=8, n_cams=n_cams,
              solve_lag=2)
    jest = JEstimator(JConfig(solver_dtype=jnp.float64, **kw))  # compiles nothing
    test = Estimator(EstimatorConfig(solver_dtype=F64, device="cpu", **kw))
    assert list(test._pack_layout) == list(jest._pack_layout)
    assert test._pack_layout == jest._pack_layout and test._pack_size == jest._pack_size
    relo = [_seed(e, 5, n_cams) for e in (jest, test)][1]
    origin = (np.array([0.1, 0.2, 0.3]), np.array([1.0, 0.0, 0.0, 0.0]))
    jbuf = jest._pack_solve_buffer(*origin, relo=relo, chain_flags=(True, False))
    tbuf = test._pack_solve_buffer(*origin, relo=relo, chain_flags=(True, False))
    np.testing.assert_array_equal(jbuf, tbuf)

    state, grid, imu, misc, rel, use, marg_prev = test._unpack(torch.from_numpy(tbuf))
    fm = test.fm
    for name, mirror in (("p", test.Ps), ("q", test.Qs), ("v", test.Vs), ("ba", test.Bas),
                         ("bg", test.Bgs), ("tic", test.tic), ("qic", test.qic)):
        np.testing.assert_array_equal(getattr(state, name).numpy(), mirror)
    assert float(state.td) == test.td
    np.testing.assert_array_equal(
        state.inv_depth.numpy(), np.where(fm.depth > 0, 1.0 / np.maximum(fm.depth, 1e-6), 1.0))
    np.testing.assert_array_equal(grid.bearing.numpy(), fm.bearing)
    np.testing.assert_array_equal(grid.velocity.numpy(), fm.velocity)
    np.testing.assert_array_equal(grid.td_obs.numpy(), fm.td_obs)
    np.testing.assert_array_equal(grid.valid.numpy(), fm.valid)
    np.testing.assert_array_equal(grid.anchor.numpy(), fm.anchor)
    np.testing.assert_array_equal(grid.used.numpy(), fm.used_mask())
    assert (grid.cam is None) == (n_cams == 1)
    if n_cams > 1:
        np.testing.assert_array_equal(grid.cam.numpy(), fm.cam)
    for x, mirror in zip(imu[:5], (test._imu_dts, test._imu_accs, test._imu_gyrs,
                                   test._imu_a0, test._imu_g0)):
        np.testing.assert_array_equal(x.numpy(), mirror[1:])
    np.testing.assert_array_equal(imu[5].numpy(),
                                  (test._imu_n[1:] > 0) & (test._imu_sumdt[1:] < 10.0))
    has_depth, op0, oq0, mi = misc
    np.testing.assert_array_equal(has_depth.numpy(), fm.depth > 0)
    np.testing.assert_array_equal(op0.numpy(), origin[0])
    np.testing.assert_array_equal(oq0.numpy(), origin[1])
    assert int(mi) == test._iterations_allowed() and bool(use) and not bool(marg_prev)
    for x, key in zip(rel, ("p", "q", "bearing", "mask")):
        np.testing.assert_array_equal(x.numpy(), relo[key])


# ------------------------------------------------------------------ _solve_E
def _align_sign(E, ref):
    """E times the sign that matches ``ref`` at ref's largest entry."""
    flat = ref.reshape(ref.shape[0], -1)
    k = np.argmax(np.abs(flat), axis=-1)
    s = np.sign(flat[np.arange(len(k)), k] * E.reshape(len(k), -1)[np.arange(len(k)), k])
    return E * s[:, None, None]


def test_solve_E_matches_jax_up_to_sign():
    """100 minimal sets and a weighted refit of noisy bearings (all around
    the rig) of one relative pose: the port's E (eigh, then E (I − v₃v₃ᵀ)) against the JAX
    package's (eigh, then svd), up to sign, within 1e-9; and the eigh
    projection equals the svd one on the same E."""
    rng = np.random.default_rng(11)
    N = 60
    # Points all around the rig, as a PAL camera sees them.
    X = rng.standard_normal((N, 3))
    X *= rng.uniform(2.0, 6.0, (N, 1)) / np.linalg.norm(X, axis=-1, keepdims=True)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    R *= np.linalg.det(R)
    b1 = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X2 = X @ R.T + [0.5, -0.3, 0.2]
    b2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True) + 1e-4 * rng.standard_normal((N, 3))
    order = np.argsort(rng.random((100, N)), axis=-1)[:, :8]
    w = (rng.random(N) < 0.8).astype(np.float64)
    for rows, wts in ((jransac._constraint_rows(b1[order], b2[order]), None),
                      (jransac._constraint_rows(b1, b2), w)):
        rows = np.asarray(rows)
        jE = np.asarray(jransac._solve_E(jnp.asarray(rows),
                                         None if wts is None else jnp.asarray(wts)))
        tE = transac._solve_E(torch.as_tensor(rows),
                              None if wts is None else torch.as_tensor(wts)).numpy()
        jE = jE.reshape(-1, 3, 3)
        tE = _align_sign(tE.reshape(-1, 3, 3), jE)
        A = torch.as_tensor(rows if wts is None else rows * wts[:, None])
        AtA = torch.einsum("...ni,...nj->...ij", A, A)
        # A null vector is defined to f64 rounding over the relative gap
        # λ₂/λ_max: two eigensolvers may differ by 1e-16 / gap. Held to 1e-9
        # where the gap is at least 1e-6 (a near-degenerate minimal set,
        # whose second eigenvalue nearly vanishes too, is left out: its E
        # depends on the solver, in JAX as anywhere).
        ev = torch.linalg.eigvalsh(AtA).reshape(-1, 9).numpy()
        posed = ev[:, 1] >= 1e-6 * ev[:, -1]
        assert posed.sum() >= 0.9 * len(posed)
        assert np.abs(tE - jE)[posed].max() <= 1e-9
        # The projection alone: svd form against eigh form on the same E.
        E = torch.linalg.eigh(AtA)[1][..., :, 0].reshape(*AtA.shape[:-2], 3, 3)
        U, S, Vt = torch.linalg.svd(E)
        S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
        ref = U @ (S2[..., :, None] * Vt)
        v3 = torch.linalg.eigh(E.transpose(-1, -2) @ E)[1][..., :, 0]
        assert float((E - (E @ v3[..., :, None]) * v3[..., None, :] - ref).abs().max()) <= 1e-12


def test_sym_eig_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper is torch.linalg.eigh and launches
    nothing."""
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((7, 9, 9)))
    A = A @ A.transpose(-1, -2)
    before = eigh_cuda.sym_eig.launches
    w, V = eigh_cuda.sym_eig(A)
    w_ref, V_ref = torch.linalg.eigh(A)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    assert eigh_cuda.sym_eig.launches == before


# ------------------------------------------------- the programs read nothing
_SYNCING = {"_local_scalar_dense", "item", "nonzero", "masked_select", "linalg_eigh",
            "_linalg_eigh", "linalg_svd", "_linalg_svd", "cholesky_solve", "linalg_solve",
            "_linalg_solve_ex", "linalg_inv", "_unique2", "unique_dim", "unique_consecutive"}


class NoReadBack(TorchDispatchMode):
    """Fails on an op that a CUDA graph cannot hold or that makes the host
    wait for the card: a scalar read (item, bool, float), nonzero and
    boolean-mask indexing, a tensor made from host data (a Python scalar
    assigned into a tensor too: on the card it is copied from the host), and
    the library's linalg
    calls that check their status on the host (eigh, svd, cholesky_solve,
    solve, inv, a checked Cholesky)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bad = name in _SYNCING
        if name == "lift_fresh":  # also a 0-dim scalar assigned into a tensor
            bad = True
        if name == "linalg_cholesky_ex" and kwargs.get("check_errors", False):
            bad = True
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            bad |= any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1])
        if bad:
            raise AssertionError(f"{name} reads the device or copies host data in")
        return func(*args, **kwargs)


def _exempt(fn):
    """``fn`` run outside the checking mode: a kernel wrapper's plain
    version (on the card the kernel runs, which reads nothing back)."""

    def wrapped(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)

    return wrapped


@contextlib.contextmanager
def programs_checked(calls):
    """Every DeviceProgram call runs under NoReadBack; ``calls`` counts them
    by program name. A program's first call runs once unchecked before, as
    its warm-up does on the card ahead of the capture (it may build cached
    constants: the capture must not)."""
    orig = tdevice.DeviceProgram.__call__

    def checked(self, *args):
        if self.name not in calls:
            orig(self, *args)
        calls[self.name] = calls.get(self.name, 0) + 1
        with NoReadBack():
            return orig(self, *args)

    tdevice.DeviceProgram.__call__ = checked
    plain, eigh_cuda.sym_eig_plain = eigh_cuda.sym_eig_plain, _exempt(eigh_cuda.sym_eig_plain)
    try:
        yield
    finally:
        tdevice.DeviceProgram.__call__ = orig
        eigh_cuda.sym_eig_plain = plain


def test_estimator_programs_read_nothing_back():
    """A bearing stream at solve lag 2 with the device chain and a wall
    budget of 2 iterations, with a loop closure armed halfway: every solve,
    relocalization solve and marginalization program runs under NoReadBack."""
    world = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu")
    pts = make_landmarks()
    # A high parallax threshold makes SECOND_NEW frames (as the solve lag 3
    # capability stream does).
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu",
                                    solve_lag=2, max_iterations=4,
                                    min_parallax=30.0 / 160.0))
    pipe = VioPipeline(BearingFrontEnd(world, pts), est, depth=1)
    calls = {}
    with programs_checked(calls):
        run_stream(pipe, world, 1.0)
        assert est.solver_flag == est.NON_LINEAR
        est._iter_time, est.cfg.max_solver_time = 0.01, 0.02  # a cap of 1 or 2
        t_loop = float(est.headers[est.WIN - 2])
        b = cam_bearings(world, t_loop, pts, np.eye(3), np.zeros(3))
        p, q = world.pose(t_loop)
        assert est.set_relo_frame(t_loop, np.arange(len(pts)), b, p, q)
        run_stream(pipe, world, 0.3, t0=1.0)
    assert est._relo_active is None and np.isfinite(np.asarray(est.traj_p)).all()
    assert {"solve_4", "marg_old", "marg_new"} <= set(calls), calls
    assert any(k.startswith("relo_") for k in calls) and "solve_1" in calls, calls


def test_frontend_published_step_reads_nothing_back():
    """The FrontEnd's published-frame step (CLAHE, pyramid, RANSAC with its
    two eigendecompositions, detection, slot assignment, lift) under
    NoReadBack, with the LK stage exempt (on the card it is one kernel
    launch) and the eigh plain version exempt (on the card it is
    ``csrc/sym_eig.cu``)."""
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.runtime.tracker import FrontEnd

    world = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=torch.float32),
                                dtype=torch.float32, device="cpu")
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, equalize=True, dtype=torch.float32, device="cpu",
                  annulus=(world.width / 2, world.height / 2, tsyn.SYN_MAX_R, tsyn.SYN_MIN_R))
    imgs = [world.render_u8(t) for t in (0.0, 1 / 15, 2 / 15)]
    fe.finalize(fe.dispatch(imgs[0], 0.0))
    fe.finalize(fe.dispatch(imgs[1], 1 / 15))
    lk, klt_cuda.pyramidal_lk = klt_cuda.pyramidal_lk, _exempt(klt_cuda.pyramidal_lk)
    plain, eigh_cuda.sym_eig_plain = eigh_cuda.sym_eig_plain, _exempt(eigh_cuda.sym_eig_plain)
    try:
        with NoReadBack():
            handle = fe.dispatch(imgs[2], 2 / 15, publish=True)
    finally:
        klt_cuda.pyramidal_lk, eigh_cuda.sym_eig_plain = lk, plain
    ids, bearings, *_, mask = fe.finalize(handle)
    assert mask.sum() >= 20 and np.isfinite(bearings[mask]).all()


def test_device_program_on_the_cpu_calls_the_function():
    calls = []

    def fn(x, pair):
        calls.append(1)
        return x + pair[0], None

    prog = tdevice.DeviceProgram(fn)
    x = torch.ones(3)
    out, none = prog(x, (torch.full((3,), 2.0), None))
    assert torch.equal(out, torch.full((3,), 3.0)) and none is None
    assert len(calls) == 1 and prog.graph is None
