"""The port's full estimator and pipeline against the JAX package, on the
CPU in f64: the relocalization rows and solve, the device state chain, the
lagged write-back, the rolling-shutter td_obs, and whole bearing-level
streams through both pipelines at solve lag 1, plain and with td estimation
(the lagged streams are in ``tests/test_torch_lag.py``).

The bearing harness (``tests/_torch_bearing_harness.py``) is the port's own
copy of ``tests/_bearing_harness.py``: a stub front end serves analytic
bearings of known landmarks, so the streams isolate the back end. The
capability bounds
of ``tests/test_capabilities.py`` are mirrored for the port as ``slow``
tests.
"""

import dataclasses
import inspect
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
from lfvio_tpu import imu as jimu
from lfvio_tpu.backend import relo as jrelo
from lfvio_tpu.geom import host as hg
from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig
from lfvio_tpu.runtime.pipeline import VioPipeline as JPipeline
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch import imu as timu
from lfvio_tpu_torch.backend import relo as trelo
from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.evaluation import ate_rmse
from lfvio_tpu_torch.runtime.pipeline import VioPipeline

F64 = torch.float64


from _torch_bearing_harness import (
    BearingFrontEnd,
    cam_bearings,
    make_landmarks,
    make_worlds,
    run_both,
    run_stream,
)


@pytest.fixture(scope="module")
def worlds():
    return make_worlds()


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def close(a, b, tol=1e-8):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(a).max()) if a.size else 1.0)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * scale, (err, scale)
    return err


# ------------------------------------------------------------ configuration
def test_config_and_pipeline_accept_the_reference_fields():
    """Every EstimatorConfig field of the JAX package but solve_device (its
    counterpart is ``device``) and every VioPipeline argument."""
    jf = {f.name for f in dataclasses.fields(JConfig)} - {"solve_device"}
    tf = {f.name for f in dataclasses.fields(EstimatorConfig)}
    assert jf <= tf and "device" in tf, jf - tf
    for f in dataclasses.fields(JConfig):
        if f.name in ("solver_dtype", "solve_device", "imu_noise", "tic", "ric"):
            continue
        assert getattr(JConfig(), f.name) == getattr(EstimatorConfig(device="cpu"), f.name), f.name
    ja = set(inspect.signature(JPipeline.__init__).parameters)
    ta = set(inspect.signature(VioPipeline.__init__).parameters)
    assert ja <= ta, ja - ta
    est = Estimator(EstimatorConfig(window=6, n_cams=2, n_feature_slots=8, max_iterations=5,
                                    estimate_td=True, estimate_extrinsic=True, device="cpu"))
    assert est.NF == 7 and est.Ps.shape == (7, 3) and est.tic.shape == (2, 3)
    assert est.scfg == convert.solver_config(dict(dataclasses.asdict(jb.SolverConfig(
        max_iterations=5, n_cams=2))))
    assert est._empty_prior().J.shape == (7 * 15 + 13,) * 2


# ------------------------------------------------------------------- relo
@pytest.fixture(scope="module")
def relo_problem():
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(5)
    s = pb["state"]
    state = dataclasses.replace(
        s, p=s.p + 0.02 * rng.standard_normal(s.p.shape), td=jnp.asarray(0.002),
        tic=jnp.asarray([0.01, -0.02, 0.005]))
    noise = pb["noise"]
    imu_raw = tuple(np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0"))
    pre = jax.jit(jax.vmap(
        lambda d, ac, gy, a0, g0, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a0, g0, ba, bg, noise)
    ))(*[jnp.asarray(x) for x in imu_raw], state.ba[:-1], state.bg[:-1])
    si, iv = jax.jit(jimu.whiten_covariance)(pre.covariance, jnp.asarray(pb["imu_valid"]))
    cfg = jb.SolverConfig(max_iterations=8)
    tst = convert.window_state(fields(state))
    tpre = timu.preintegrate(*[t(x) for x in imu_raw], tst.ba[:-1], tst.bg[:-1],
                             convert.imu_noise(fields(noise)))
    tsi, tiv = timu.whiten_covariance(tpre.covariance, torch.as_tensor(np.asarray(pb["imu_valid"])))
    # The loop frame: window frame 3 seen again, with bearing noise, from a
    # pose a few centimetres off.
    Fn = 32
    b = np.asarray(pb["grid"].bearing)[:, 3] + 3e-3 * rng.standard_normal((Fn, 3))
    mask = rng.random(Fn) < 0.7
    rp = np.asarray(state.p[3]) + 0.03 * rng.standard_normal(3)
    rq = np.asarray(state.q[3])
    return dict(
        j=(state, pb["grid"], pre, si, iv, pb["prior"], pb["gravity"], cfg),
        t=(tst, convert.feature_grid(fields(pb["grid"])), tpre, tsi, tiv,
           convert.prior_factor(fields(pb["prior"])), t(pb["gravity"]),
           convert.solver_config(dataclasses.asdict(cfg))),
        relo=(rp, rq, b, mask),
    )


def test_linearize_relo_rows(relo_problem):
    st, grid, *_, cfg = relo_problem["j"]
    tst, tgrid, *_, tcfg = relo_problem["t"]
    rp, rq, b, mask = relo_problem["relo"]
    ja = jax.jit(jrelo.linearize_relo_rows, static_argnums=6)(
        st, grid, jnp.asarray(rp), jnp.asarray(rq), jnp.asarray(b), jnp.asarray(mask), cfg)
    ta = trelo.linearize_relo_rows(tst, tgrid, t(rp), t(rq), t(b), torch.as_tensor(mask), tcfg)
    assert ta[1].shape == (32, 2, 172 + 6)
    assert (np.asarray(ja[3]) == ta[3].numpy()).all()
    for i in (0, 1, 2, 4):
        close(ja[i], ta[i])


def test_lm_solve_relo(relo_problem):
    """The D+6 system through the shared lm_loop: states and the refined
    loop pose within 1e-7."""
    st, grid, pre, si, iv, prior, g, cfg = relo_problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = relo_problem["t"]
    rp, rq, b, mask = relo_problem["relo"]
    jo = jax.jit(jrelo.lm_solve_relo, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg, jnp.asarray(rp), jnp.asarray(rq),
        jnp.asarray(b), jnp.asarray(mask))
    to = trelo.lm_solve_relo(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg,
                             t(rp), t(rq), t(b), torch.as_tensor(mask))
    close(jo[3], to[3], 1e-9)
    close(jo[4], to[4], 1e-7)
    assert float(to[4]) < float(to[3])
    close(jo[1], to[1], 1e-7)
    close(jo[2], to[2], 1e-7)
    assert float((to[1] - t(rp)).abs().max()) > 1e-3  # the loop pose moved
    for name in ("p", "q", "v", "tic", "td", "inv_depth"):
        close(getattr(jo[0], name), getattr(to[0], name), 1e-7)


# ------------------------------------------------------- the device chain
@pytest.mark.parametrize("marg_prev", [True, False], ids=["after_old", "after_second_new"])
def test_apply_chain_matches_jax_scan(marg_prev):
    """The port's log-depth advance of the chained window against the JAX
    package's lax.scan, after either kind of slide: 1e-10."""
    rng = np.random.default_rng(2)
    W, M, Fn = 6, 24, 8
    kw = dict(window=W, n_feature_slots=Fn, max_imu_per_interval=M, solve_lag=2)
    jest = JEstimator(JConfig(solver_dtype=jnp.float64, **kw))
    test = Estimator(EstimatorConfig(solver_dtype=F64, device="cpu", **kw))
    q = rng.standard_normal((W + 1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    chain = (rng.standard_normal((W + 1, 3)), q, rng.standard_normal((W + 1, 3)),
             0.05 * rng.standard_normal((W + 1, 3)), 0.01 * rng.standard_normal((W + 1, 3)),
             np.array([0.01, 0.02, -0.01]), np.array([1.0, 0, 0, 0]), np.array(0.003))
    dts = np.full((W, M), 0.005)
    dts[:, 17:] = 0.0  # padding
    accs = rng.standard_normal((W, M, 3)) + [0, 0, 9.81]
    gyrs = 0.5 * rng.standard_normal((W, M, 3))
    a0, g0 = accs[:, 0] + 0.1, gyrs[:, 0] - 0.05
    packed = np.zeros(jest._pack_size)
    packed[jest._pack_layout["use_chain"][0]] = 1.0
    packed[jest._pack_layout["marg_prev"][0]] = float(marg_prev)
    jstate = jb.WindowState.zeros(Fn, jnp.float64, W + 1)
    jout, jp0, jq0, use = jest._apply_chain(
        jstate, jnp.asarray(packed), tuple(jnp.asarray(c) for c in chain),
        *[jnp.asarray(x) for x in (dts, accs, gyrs, a0, g0)])
    assert bool(use)
    tstate = convert.window_state(fields(jstate))
    tout = test._apply_chain(tstate, tuple(t(c) for c in chain), marg_prev,
                             *[t(x) for x in (dts, accs, gyrs, a0, g0)])
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth"):
        close(getattr(jout, name), getattr(tout, name), 1e-10)
    close(jp0, tout.p[0], 1e-10)
    close(jq0, tout.q[0], 1e-10)
    # The new frame really moved off the previous newest one.
    assert float((tout.p[W] - tout.p[W - 1]).abs().max()) > 1e-2


# --------------------------------------------------------- host bookkeeping
def _seed_estimators(rng, **kw):
    """A JAX and a port estimator with the same random mirrors, IMU window
    and feature table."""
    jest = JEstimator(JConfig(solver_dtype=jnp.float64, **kw))
    test = Estimator(EstimatorConfig(solver_dtype=F64, device="cpu", **kw))
    W1, Fn = jest.NF, jest.cfg.n_feature_slots
    q = rng.standard_normal((W1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vals = dict(
        Ps=rng.standard_normal((W1, 3)), Qs=q, Vs=rng.standard_normal((W1, 3)),
        Bas=0.05 * rng.standard_normal((W1, 3)), Bgs=0.01 * rng.standard_normal((W1, 3)),
        _imu_dts=np.full(jest._imu_dts.shape, 0.005),
        _imu_accs=rng.standard_normal(jest._imu_accs.shape) + [0, 0, 9.81],
        _imu_gyrs=0.5 * rng.standard_normal(jest._imu_gyrs.shape),
        _imu_n=rng.integers(3, jest._imu_dts.shape[1], W1),
        _imu_a0=rng.standard_normal((W1, 3)), _imu_g0=0.3 * rng.standard_normal((W1, 3)),
    )
    fm_vals = dict(feature_id=np.arange(Fn) + 100, anchor=rng.integers(0, 3, Fn),
                   depth=rng.uniform(2, 6, Fn), valid=np.ones((Fn, W1), bool))
    for est in (jest, test):
        est.frame_count = est.WIN
        est.solver_flag = est.NON_LINEAR
        for k, v in vals.items():
            setattr(est, k, v.copy())
        for k, v in fm_vals.items():
            getattr(est.fm, k)[:] = v
    return jest, test


@pytest.mark.parametrize("slides", [(True, False), (False, True), (True, True)],
                         ids=["old_new", "new_old", "old_old"])
def test_write_back_lagged(slides):
    """A hand-built pending solve rebased through two stacked slides: the
    slot mapping, the re-propagated trailing slots and the depth
    applicability (snap_anchor − n_old) agree with the JAX package's to
    rounding."""
    rng = np.random.default_rng(4)
    jest, test = _seed_estimators(rng, window=6, n_feature_slots=12, max_imu_per_interval=16,
                                  solve_lag=3, estimate_td=True, estimate_extrinsic=True)
    W1, Fn = 7, 12
    q = rng.standard_normal((W1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    state_host = [rng.standard_normal((W1, 3)), q, rng.standard_normal((W1, 3)),
                  0.05 * rng.standard_normal((W1, 3)), 0.01 * rng.standard_normal((W1, 3)),
                  np.array([0.02, 0.0, -0.01]), np.array([1.0, 0, 0, 0]), np.array(0.004),
                  1.0 / rng.uniform(2, 6, Fn)]
    snap_anchor = jest.fm.anchor + sum(slides)  # physical anchors before the slides
    snap_anchor[::4] += 1  # some slots re-anchored since: not applicable
    snap_id = jest.fm.feature_id.copy()
    snap_id[1::5] = 7  # some slots changed hands
    pend = dict(slides=list(slides), snap_used=np.ones(Fn, bool), snap_id=snap_id,
                snap_anchor=snap_anchor)
    jest._write_back_lagged(pend, [a.copy() for a in state_host])
    test._write_back_lagged(pend, [a.copy() for a in state_host])
    for name in ("Ps", "Qs", "Vs", "Bas", "Bgs", "tic", "qic"):
        close(getattr(jest, name), getattr(test, name), 1e-12)
    assert jest.td == test.td == 0.004
    close(jest.fm.depth, test.fm.depth, 1e-12)
    changed = test.fm.depth != _seed_estimators(np.random.default_rng(4), window=6,
                                                n_feature_slots=12, max_imu_per_interval=16,
                                                solve_lag=3)[1].fm.depth
    assert 0 < changed.sum() < Fn


def test_rolling_shutter_td_obs_and_gate():
    """td_obs = td_pair − TR/ROW·(row − ROW/2) per observation, and the
    (normally disabled) reprojection gate's bookkeeping, like the JAX
    package's."""
    kw = dict(window=4, n_feature_slots=8, rolling_shutter_tr=0.02, image_rows=384)
    jest = JEstimator(JConfig(solver_dtype=jnp.float64, **kw))
    test = Estimator(EstimatorConfig(solver_dtype=F64, device="cpu", **kw))
    rng = np.random.default_rng(0)
    b = rng.standard_normal((6, 3))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    rows = rng.uniform(0, 384, 6)
    for est in (jest, test):
        for k in range(3):
            est.process_image_arrays(np.arange(6), b, np.zeros((6, 3)), rows,
                                     np.ones(6, bool), 0.1 * k, td_pair=0.003)
    np.testing.assert_array_equal(jest.fm.td_obs, test.fm.td_obs)
    assert np.ptp(test.fm.td_obs[test.fm.valid]) > 1e-3
    rn = rng.uniform(0, 2, test.fm.valid.shape)
    for est in (jest, test):
        est.GATE_THRESH = 1.5
        est._gate_observations(rn, est.fm.valid.copy())
    np.testing.assert_array_equal(jest.fm.valid, test.fm.valid)
    np.testing.assert_array_equal(jest.fm.anchor, test.fm.anchor)
    np.testing.assert_array_equal(jest.fm.feature_id, test.fm.feature_id)


# ------------------------------------------------------------------ streams
@pytest.mark.parametrize("key", ["lag1", "td"])
def test_stream_matches_jax(worlds, key):
    """One bearing-harness stream (48 landmarks, 64 slots, 20 Hz, 1.5 s)
    through both pipelines: the same initialization frame, the same solve
    times, trajectories within 1e-6 m, and td within 1e-7 s."""
    jest, test, jp, tp, *_ = run_both(key, worlds)
    assert test.solver_flag == test.NON_LINEAR == jest.solver_flag
    assert len(test.times) == len(jest.times) >= (5 if "throttled" in key else 15)
    np.testing.assert_array_equal(test.times, jest.times)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= 1e-6
    assert np.abs(np.asarray(test.traj_q) - np.asarray(jest.traj_q)).max() <= 1e-6
    assert abs(test.td - jest.td) <= 1e-7
    for name in ("Ps", "Vs", "Bas", "Bgs"):
        assert np.abs(getattr(test, name) - getattr(jest, name)).max() <= 1e-6, name
    np.testing.assert_array_equal(test.fm.feature_id, jest.fm.feature_id)
    assert len(tp.high_rate) == len(jp.high_rate) > 50
    if key == "td":
        assert abs(test.td) > 1e-3  # td moved towards the planted 5 ms


def test_solver_budget_calibration(worlds):
    """calibrate_solver_budget measures a positive time per iteration on the
    estimator's device and _iterations_allowed turns a wall budget into the
    iteration cap (x0.8 when marginalizing old), as the JAX package's does."""
    _, test, *_ = run_both("lag1", worlds)
    before = [a.copy() for a in (test.Ps, test.Qs, test.fm.depth)]
    assert test._iterations_allowed() == test.cfg.max_iterations
    it = test.calibrate_solver_budget(n=1)
    assert it is not None and it > 0 and test._iter_time == it
    for a, b in zip(before, (test.Ps, test.Qs, test.fm.depth)):
        np.testing.assert_array_equal(a, b)  # read-only
    try:
        test.cfg.max_solver_time = 1e-7
        test.marg_old = False
        assert test._iterations_allowed() == 1
        test.cfg.max_solver_time = 1e3
        assert test._iterations_allowed() == test.cfg.max_iterations
        test.cfg.max_solver_time = it * 5.0
        cap_new = test._iterations_allowed()
        assert cap_new == 5
        test.marg_old = True
        assert test._iterations_allowed() == 4
    finally:
        test.cfg.max_solver_time = 0.0
        test._iter_time = None


def test_set_relo_frame_matches_jax(worlds):
    """After the lag-1 stream: set_relo_frame's PnP outputs within 1e-8 of
    the JAX package's, then the relo solve of the next frames refines the
    loop pose on both sides alike (1e-6) and beats the PnP seed."""
    jest, test, jp, tp, jw, tw, pts = run_both("lag1", worlds)
    idx = test.WIN - 2
    t_loop = float(test.headers[idx])
    assert t_loop == float(jest.headers[idx])
    rng = np.random.default_rng(7)
    b = cam_bearings(tw, t_loop, pts, np.eye(3), np.zeros(3))
    b = b + 4e-3 * rng.standard_normal(b.shape)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    drift_R = hg.ypr_deg_to_R([12.0, 0.0, 0.0])
    p_true, q_true = tw.pose(t_loop)
    prev_p = drift_R @ p_true + np.array([0.4, -0.3, 0.1])
    prev_q = hg.mat_to_quat(drift_R @ hg.quat_to_mat(q_true))
    for est in (jest, test):
        assert est.set_relo_frame(t_loop, np.arange(len(pts)), b, prev_p, prev_q)
    names = ("relo_relative_t", "relo_relative_q", "relo_relative_yaw", "drift_correct_r",
             "drift_correct_t")
    for name in names:
        close(getattr(jest, name), getattr(test, name), 1e-8)
    assert abs(hg.R_to_ypr_deg(test.drift_correct_r)[0] - 12.0) < 5.0
    pnp_err = float(np.linalg.norm(test.relo_relative_t))
    assert test._relo_active is not None
    run_stream(jp, jw, 0.3, t0=1.5)
    run_stream(tp, tw, 0.3, t0=1.5)
    assert test._relo_active is None and len(test.times) == len(jest.times)
    for name in names:
        close(getattr(jest, name), getattr(test, name), 1e-6)
    refined = float(np.linalg.norm(test.relo_relative_t))
    assert refined < pnp_err and refined < 0.1, (refined, pnp_err)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= 1e-6


# ----------------------------------------------- capability bounds (slow)


@pytest.mark.slow
def test_port_td_estimation_recovers_planted_offset(worlds):
    tw = tsyn.SyntheticWorld(camera=worlds[1].camera, traj_freq=0.8, dtype=F64, device="cpu")
    est = Estimator(EstimatorConfig(n_feature_slots=64, estimate_td=True, solver_dtype=F64,
                                    device="cpu"))
    run_stream(VioPipeline(BearingFrontEnd(tw, make_landmarks(), td_true=0.005), est), tw, 4.0)
    assert est.solver_flag == est.NON_LINEAR
    assert abs(est.td - 0.005) < 5e-4, est.td


@pytest.mark.slow
def test_port_online_extrinsic_rotation_calibration(worlds):
    ric_true = hg.ypr_deg_to_R([25.0, 8.0, -12.0])
    est = Estimator(EstimatorConfig(n_feature_slots=64, estimate_extrinsic=True,
                                    calib_extrinsic_rotation=True, solver_dtype=F64,
                                    device="cpu"))
    assert not est.extrinsic_calibrated
    tw = tsyn.SyntheticWorld(camera=worlds[1].camera, traj_freq=1.5, dtype=F64, device="cpu")
    run_stream(VioPipeline(BearingFrontEnd(tw, make_landmarks(), ric=ric_true), est), tw, 3.5,
               frame_rate=10.0)
    assert est.extrinsic_calibrated
    R_est = hg.quat_to_mat(est.qic)
    ang = np.degrees(np.arccos(np.clip((np.trace(R_est.T @ ric_true) - 1) / 2, -1, 1)))
    assert ang < 3.0, ang
    assert est.solver_flag == est.NON_LINEAR


@pytest.mark.slow
@pytest.mark.parametrize("kw,duration", [(dict(window=20), 4.0),
                                         (dict(solve_lag=3, min_parallax=30.0 / 160.0), 5.0)],
                         ids=["window20", "lag3_mixed_slides"])
def test_port_window_and_lag_ate(worlds, kw, duration):
    traj_freq = 0.5 if "solve_lag" in kw else 0.25
    tw = tsyn.SyntheticWorld(camera=worlds[1].camera, traj_freq=traj_freq, dtype=F64,
                             device="cpu")
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu", **kw))
    run_stream(VioPipeline(BearingFrontEnd(tw, make_landmarks()), est), tw, duration)
    assert est.solver_flag == est.NON_LINEAR
    ts = np.asarray(est.times)
    ate, n = ate_rmse(ts, np.asarray(est.traj_p), ts, tw.pose_batch(ts)[0])
    assert n >= 30 and ate < 0.25, (n, ate)


@pytest.mark.slow
def test_port_solver_wall_budget_binds(worlds):
    tw = worlds[1]
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, max_solver_time=1e-7,
                                    device="cpu"))
    run_stream(VioPipeline(BearingFrontEnd(tw, make_landmarks()), est), tw, 3.0)
    assert est.solver_flag == est.NON_LINEAR
    assert est._iter_time is not None and est._iter_time > 0
    est.marg_old = False
    assert est._iterations_allowed() == 1
