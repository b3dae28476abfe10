"""Parity of the port's multi-camera (dual-PAL) path with the JAX package,
on the CPU in f64: per-camera extrinsics in ``WindowState``, the
per-observation camera id of ``FeatureGrid``, the camera-major extrinsic
columns of the D = 15·(W+1) + 6·C + 1 layout, and the image-level
``DualFrontEnd`` with its shared feature-id space.

The JAX forms select each observation's camera with one-hot contractions;
the port indexes (``tics[cam]``) and scatters the extrinsic blocks with
``index_add_``. Bounds: 1e-8 on residuals, rows and normal equations, 1e-7
on solved states (eight iterations of f64 linear solves).
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
from lfvio_tpu import imu as jimu
from lfvio_tpu.backend import marginalize as jmarg
from lfvio_tpu.backend import solver as jsolver
from lfvio_tpu.backend import triangulate as jtri
from lfvio_tpu.backend.state import NFRAMES, pose_dim as j_pose_dim
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch import imu as timu
from lfvio_tpu_torch.backend import factors as tfactors
from lfvio_tpu_torch.backend import marginalize as tmarg
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.backend import state as tstate_mod
from lfvio_tpu_torch.backend import triangulate as ttri

F64 = torch.float64


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def close(a, b, tol=1e-8):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(a).max()) if a.size else 1.0)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * scale, (err, scale)
    return err


def _small_quat(rng, scale):
    th = scale * rng.standard_normal(3)
    q = np.concatenate([[1.0], 0.5 * th])
    return q / np.linalg.norm(q)


@pytest.fixture(scope="module")
def problem():
    """make_window_problem's 32-feature window turned into a two-camera
    one: a second extrinsic a few centimetres and 0.02 rad from the first,
    a random camera per observation (so single tracks mix cameras), td and
    extrinsics estimated, and an informative random prior over the 178-dim
    layout whose residual is non-zero."""
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(11)
    s = pb["state"]
    Fn = s.inv_depth.shape[0]
    tic = np.array([[0.01, -0.02, 0.005], [-0.015, 0.03, -0.04]])
    qic = np.stack([_small_quat(rng, 0.01), _small_quat(rng, 0.02)])
    state = dataclasses.replace(
        s,
        p=s.p + 0.02 * rng.standard_normal(s.p.shape),
        ba=s.ba + 0.01 * rng.standard_normal(s.ba.shape),
        bg=s.bg + 0.001 * rng.standard_normal(s.bg.shape),
        td=jnp.asarray(0.003), tic=jnp.asarray(tic), qic=jnp.asarray(qic),
    )
    cam = rng.integers(0, 2, (Fn, NFRAMES)).astype(np.int32)
    grid = dataclasses.replace(pb["grid"], cam=jnp.asarray(cam))
    D = j_pose_dim(NFRAMES, 2)
    assert D == 178
    x0 = dataclasses.replace(
        state, p=state.p + 0.01 * rng.standard_normal(state.p.shape),
        tic=jnp.asarray(tic + 0.002 * rng.standard_normal(tic.shape)),
        td=jnp.asarray(0.001),
    )
    prior = jb.PriorFactor.from_state(
        jnp.asarray(np.triu(0.5 * rng.standard_normal((D, D))) + 2.0 * np.eye(D)),
        jnp.asarray(0.1 * rng.standard_normal(D)), x0,
    )
    noise = pb["noise"]
    imu_raw = tuple(np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0"))
    pre = jax.jit(jax.vmap(
        lambda d, ac, gy, a0, g0, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a0, g0, ba, bg, noise)
    ))(*[jnp.asarray(x) for x in imu_raw], state.ba[:-1], state.bg[:-1])
    si, iv = jax.jit(jimu.whiten_covariance)(pre.covariance, jnp.asarray(pb["imu_valid"]))
    cfg = jb.SolverConfig(max_iterations=8, n_cams=2)
    tst = convert.window_state(fields(state))
    tpre = timu.preintegrate(*[t(x) for x in imu_raw], tst.ba[:-1], tst.bg[:-1],
                             convert.imu_noise(fields(noise)))
    tsi, tiv = timu.whiten_covariance(tpre.covariance, torch.as_tensor(np.asarray(pb["imu_valid"])))
    return dict(
        j=(state, grid, pre, si, iv, prior, pb["gravity"], cfg),
        t=(tst, convert.feature_grid(fields(grid)), tpre, tsi, tiv,
           convert.prior_factor(fields(prior)), t(pb["gravity"]),
           convert.solver_config(dataclasses.asdict(cfg))),
    )


def test_layout_offsets():
    from lfvio_tpu.backend import state as jstate

    for nf, nc in ((11, 1), (11, 2), (21, 2), (6, 3)):
        assert tstate_mod.pose_dim(nf, nc) == jstate.pose_dim(nf, nc)
        assert tstate_mod.ex_off(nf) == jstate.ex_off(nf)
        assert tstate_mod.td_off(nf, nc) == jstate.td_off(nf, nc)
        assert tstate_mod.sb_off(3, nf) == jstate.sb_off(3, nf)
    z1 = tstate_mod.WindowState.zeros(4, F64, 7)
    z2 = tstate_mod.WindowState.zeros(4, F64, 7, n_cams=2)
    assert z1.tic.shape == (3,) and z2.tic.shape == (2, 3) and z2.qic.shape == (2, 4)
    assert tstate_mod.n_cams_of(z1) == 1 and tstate_mod.n_cams_of(z2) == 2
    assert tstate_mod.ex_2d(z1.tic, z1.qic)[0].shape == (1, 3)
    assert tstate_mod.PriorFactor.empty(F64, 7, n_cams=2).J.shape == (7 * 15 + 13,) * 2


def test_dualcam_residuals(problem):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    assert tgrid.cam is not None and tgrid.cam.dtype == torch.int64
    jr, jv = jax.jit(jb.projection_residuals_grid)(st, grid, jnp.asarray(cfg.proj_sqrt_info))
    tr, tv = tfactors.projection_residuals_grid(tst, tgrid, tcfg.proj_sqrt_info)
    assert (np.asarray(jv) == tv.numpy()).all()
    close(jr, tr)
    close(jb.prior_residual(st, prior), tfactors.prior_residual(tst, tprior))
    close(jax.jit(jtri.triangulate_grid)(st, grid, jnp.zeros(grid.used.shape, bool)),
          ttri.triangulate_grid(tst, tgrid, torch.zeros_like(tgrid.used)))


def test_indexing_equals_the_onehot_form(problem):
    """tics[cam] and the index_add_ scatter against the JAX package's
    one-hot contractions written out in torch, exactly."""
    tst, tgrid, *_, tcfg = problem["t"]
    Fn, W1 = tgrid.valid.shape
    oh = torch.nn.functional.one_hot(tgrid.cam, 2).to(F64)  # [F, W1, C]
    oh_a = torch.nn.functional.one_hot(tgrid.anchor, W1).to(F64)
    tic_i, qic_i, tic_j, qic_j = tfactors.obs_extrinsics(tst, tgrid)
    assert torch.equal(tic_j, torch.einsum("fwc,cd->fwd", oh, tst.tic))
    assert torch.equal(qic_j, torch.einsum("fwc,cd->fwd", oh, tst.qic))
    assert torch.equal(tic_i, torch.einsum("fw,fwd->fd", oh_a, tic_j))
    res, J26, valid, w = tsolver.linearize_projection(tst, tgrid, tcfg)
    J26 = J26 * w[..., None]
    oh_i = torch.einsum("fw,fwc->fc", oh_a, oh)
    Jex = (torch.einsum("fjac,fjC->fjaCc", J26[..., 18:24], oh)
           + torch.einsum("fjac,fC->fjaCc", J26[..., 12:18], oh_i)).reshape(Fn, W1, 2, 12)
    Jfull = tsolver.linearize_proj_rows(tst, tgrid, tcfg)[1]
    e0 = tstate_mod.ex_off(W1)
    assert float((Jfull[..., e0:e0 + 12] - Jex).abs().max()) <= 1e-12 * float(Jex.abs().max())


@pytest.mark.parametrize("est_td,est_ex", [(True, True), (False, True), (True, False)])
def test_dualcam_rows_and_normal_equations(problem, est_td, est_ex):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    cfg = dataclasses.replace(cfg, estimate_td=est_td, estimate_extrinsic=est_ex)
    tcfg = dataclasses.replace(tcfg, estimate_td=est_td, estimate_extrinsic=est_ex)
    ja = jax.jit(jsolver.linearize_proj_rows, static_argnums=2)(st, grid, cfg)
    ta = tsolver.linearize_proj_rows(tst, tgrid, tcfg)
    assert ta[1].shape[-1] == 178
    for i in (0, 1, 2, 4):
        close(ja[i], ta[i])
    e0 = tstate_mod.ex_off(NFRAMES)
    assert bool(ta[1][..., e0:e0 + 12].abs().max() > 0) == est_ex
    assert bool(ta[1][..., -1].abs().max() > 0) == est_td
    jn = jax.jit(jsolver.assemble_normal_equations, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg)
    tn = tsolver.assemble_normal_equations(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    for x, y in zip(jn, tn):
        close(x, y)


def test_dualcam_lm_solve(problem):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    jout, jc0, jc1, _ = jax.jit(jb.lm_solve, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg)
    tout, tc0, tc1, _ = tsolver.lm_solve(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    close(jc0, tc0, 1e-9)
    close(jc1, tc1, 1e-7)
    assert float(tc1) < float(tc0)
    assert tout.tic.shape == (2, 3) and not torch.equal(tout.tic, tst.tic)
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth"):
        close(getattr(jout, name), getattr(tout, name), 1e-7)


@pytest.mark.parametrize("cap", [1, 3])
def test_lm_solve_max_iter_dyn(problem, cap):
    """The dynamic iteration cap: the JAX scalar against the port's int."""
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    jout, _, jc1, _ = jax.jit(jb.lm_solve, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg, jnp.asarray(cap, jnp.int32))
    tout, _, tc1, hist = tsolver.lm_solve(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg,
                                          max_iter_dyn=cap)
    assert len(hist) == cap
    close(jc1, tc1, 1e-7)
    for name in ("p", "q", "v", "tic", "td", "inv_depth"):
        close(getattr(jout, name), getattr(tout, name), 1e-7)


def _info(J, r):
    J, r = np.asarray(J, np.float64), np.asarray(r, np.float64)
    return J.T @ J, J.T @ r, r @ r


@pytest.mark.parametrize("kind", ["old", "second_new"])
def test_dualcam_marginalize_qr(problem, kind):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    if kind == "old":
        jp = jax.jit(jmarg.marginalize_old_qr, static_argnums=7)(
            st, grid, pre, si, iv, prior, g, cfg)
        tp = tmarg.marginalize_old_qr(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    else:
        jp = jax.jit(jmarg.marginalize_second_new_qr, static_argnums=2)(st, prior, cfg)
        tp = tmarg.marginalize_second_new_qr(tst, tprior, tcfg)
    assert bool(jp.valid) and bool(tp.valid) and tp.J.shape == (178, 178)
    for x, y in zip(_info(jp.J, jp.r0), _info(tp.J.numpy(), tp.r0.numpy())):
        close(x, y)
    for name in ("x0_p", "x0_q", "x0_tic", "x0_qic", "x0_td"):
        close(getattr(jp, name), getattr(tp, name), 1e-12)


# ------------------------------------------------------- estimator, n_cams=2
TICS = np.array([[0.0, 0.0, 0.05], [0.0, 0.0, -0.05]])
RICS = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0])])
COS_MAX, COS_MIN = np.cos(np.radians(40.0)), np.cos(np.radians(120.0))


class DualPalStub:
    """Analytic dual-PAL tracker stub (tests/test_multicam.py's): shared
    world landmarks projected into whichever camera's annulus holds them;
    overlap-zone landmarks alternate cameras across frames, so single tracks
    carry observations of both cameras."""

    def __init__(self, world, pts_w, vel_eps=5e-4):
        self.world, self.pts_w, self.vel_eps = world, np.asarray(pts_w, np.float64), vel_eps
        self.frame_idx = 0

    def process_arrays(self, img, t, publish=True):
        from _torch_bearing_harness import cam_bearings

        if not publish:
            return None
        n = len(self.pts_w)
        b, b2 = (np.stack([cam_bearings(self.world, tt, self.pts_w, RICS[c], TICS[c])
                           for c in range(2)]) for tt in (float(t), float(t) + self.vel_eps))
        vis = (b[..., 2] >= COS_MIN) & (b[..., 2] <= COS_MAX)
        alt = (self.frame_idx + np.arange(n)) % 2
        cam = np.where(vis[0] & ~vis[1], 0, np.where(vis[1] & ~vis[0], 1, alt))
        self.frame_idx += 1
        sel = np.arange(n)
        return sel, b[cam, sel], ((b2 - b) / self.vel_eps)[cam, sel], np.zeros(n), \
            vis[0] | vis[1], cam

    def reset(self):
        pass


def _dual_scene():
    from _torch_bearing_harness import make_landmarks

    ang = np.random.default_rng(5).uniform(0, 2 * np.pi, 12)
    ring = lambda a, z: np.stack([4.0 * np.cos(a), 4.0 * np.sin(a), np.full(12, z)], -1)
    return np.concatenate([make_landmarks(n=40, seed=3), ring(ang, 3.4), ring(ang + 0.3, -3.4)])


def test_dual_pal_estimator_stream_matches_jax():
    """The n_cams = 2 estimator on a bearing-level dual-PAL stream with
    extrinsics estimated, through both pipelines (the JAX one marginalizing
    with the eigh forms, ``eigh_marginalizing``): same solve times,
    trajectories and per-camera extrinsics within 1e-6, mixed-camera tracks
    in the window."""
    from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig
    from lfvio_tpu.runtime.pipeline import VioPipeline as JPipeline
    from lfvio_tpu.runtime.synthetic import SyntheticWorld as JWorld, make_synthetic_pal_camera
    from lfvio_tpu_torch.runtime import synthetic as tsyn
    from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
    from lfvio_tpu_torch.runtime.pipeline import VioPipeline
    from _torch_bearing_harness import eigh_marginalizing, run_stream

    jw = JWorld(camera=make_synthetic_pal_camera(dtype=jnp.float64), traj_freq=0.6)
    tw = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), traj_freq=0.6,
                             dtype=F64, device="cpu")
    pts = _dual_scene()
    kw = dict(n_feature_slots=96, n_cams=2, tic=TICS, ric=RICS, estimate_extrinsic=True)
    jest = eigh_marginalizing(JEstimator(JConfig(solver_dtype=jnp.float64, **kw)))
    test = Estimator(EstimatorConfig(solver_dtype=F64, device="cpu", **kw))
    run_stream(JPipeline(DualPalStub(jw, pts), jest), jw, 1.5)
    run_stream(VioPipeline(DualPalStub(tw, pts), test), tw, 1.5)
    assert test.solver_flag == test.NON_LINEAR == jest.solver_flag
    assert len(test.times) == len(jest.times) >= 15
    np.testing.assert_array_equal(test.times, jest.times)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= 1e-6
    assert test.tic.shape == (2, 3) and np.abs(test.tic - jest.tic).max() <= 1e-6
    assert np.abs(test.qic - jest.qic).max() <= 1e-6 and np.abs(test.tic - TICS).max() > 0
    np.testing.assert_array_equal(test.fm.cam, jest.fm.cam)
    live = np.where(test.fm.feature_id >= 0)[0]
    assert any(len(np.unique(test.fm.cam[s][test.fm.valid[s]])) > 1 for s in live)
    assert test.prior.J.shape == (178, 178)


def _dual_frontends(tw, **kw):
    from lfvio_tpu_torch.runtime.synthetic import SYN_MAX_R, SYN_MIN_R
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd, FrontEnd

    H, W = tw.height, tw.width
    fes = [FrontEnd(tw.camera, (H, W), max_cnt=90, min_dist=15, n_slots=128,
                    annulus=(W / 2, H / 2, SYN_MAX_R, SYN_MIN_R), equalize=False, seed=c, **kw)
           for c in range(2)]
    return fes, DualFrontEnd(*fes)


def test_dual_frontend_matches_jax():
    """Four rendered frame pairs (up and down camera) through both packages'
    DualFrontEnd with the JAX key chains' RANSAC draws handed to the port:
    ids (one shared sequence), publish masks and camera ids exactly equal,
    bearings within 1e-6; dispatch + finalize equals process_arrays."""
    from lfvio_tpu.runtime import tracker as jtr
    from lfvio_tpu.runtime.synthetic import (SYN_MAX_R, SYN_MIN_R, SyntheticWorld as JWorld,
                                             make_synthetic_pal_camera)
    from lfvio_tpu_torch.runtime import synthetic as tsyn

    jw = JWorld(camera=make_synthetic_pal_camera(dtype=jnp.float64))
    tw = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                             device="cpu")
    H, W = jw.height, jw.width
    jfes = [jtr.FrontEnd(jw.camera, (H, W), max_cnt=90, min_dist=15, n_slots=128,
                         annulus=(W / 2, H / 2, SYN_MAX_R, SYN_MIN_R), equalize=False,
                         dtype=jnp.float64, seed=c) for c in range(2)]
    jfe = jtr.DualFrontEnd(*jfes)
    tfes, tfe = _dual_frontends(tw, dtype=F64, device="cpu")
    tfes_b, tfe_b = _dual_frontends(tw, dtype=F64, device="cpu")
    assert tfes[1]._ids_src is tfes[0]._ids_src
    keys = [jax.random.PRNGKey(c) for c in range(2)]
    for k in range(4):
        imgs = tuple(jw.render_rig(k / 15.0, RICS[c], TICS[c]) for c in range(2))
        if k:
            for c in range(2):
                keys[c], sub = jax.random.split(keys[c])
                u = np.asarray(jax.random.uniform(sub, (100, 128)))
                for f in (tfes[c], tfes_b[c]):
                    f.ransac_draws = lambda u=u: torch.as_tensor(u)
        jo = jfe.process_arrays(imgs, k / 15.0)
        to = tfe.process_arrays(imgs, k / 15.0)
        tb = tfe_b.finalize(tfe_b.dispatch(imgs, k / 15.0))
        if k == 0:
            assert jo is None and to is None and tb is None
            continue
        assert len(to) == 6
        for i in (0, 4, 5):
            np.testing.assert_array_equal(to[i], jo[i])
        np.testing.assert_allclose(to[1], jo[1], atol=1e-6)
        np.testing.assert_allclose(to[2], jo[2], atol=1e-5)
        for x, y in zip(to, tb):
            np.testing.assert_array_equal(x, y)
    live = to[0][to[0] >= 0]
    assert len(np.unique(live)) == len(live) and to[4][to[5] == 1].sum() > 30


@pytest.mark.slow
def test_port_dual_pal_rendered_image_pipeline():
    """tests/test_multicam.py::test_dual_pal_rendered_image_pipeline for the
    port on the CPU: both cameras in the window, ATE < 0.25 m."""
    from lfvio_tpu_torch.runtime import synthetic as tsyn
    from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse
    from lfvio_tpu_torch.runtime.pipeline import VioPipeline

    tw = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                             device="cpu")
    _, fe = _dual_frontends(tw, dtype=torch.float32, device="cpu")
    est = Estimator(EstimatorConfig(n_feature_slots=256, n_cams=2, tic=TICS, ric=RICS,
                                    solver_dtype=F64, device="cpu"))
    times, traj_p, _ = VioPipeline(fe, est).run(
        tw.generate(6.0, 15.0, 200.0),
        lambda tt: tuple(tw.render_rig(tt, RICS[c], TICS[c]) for c in range(2)))
    assert est.solver_flag == est.NON_LINEAR and len(times) > 30
    cams = est.fm.cam[est.fm.valid]
    assert (cams == 0).any() and (cams == 1).any()
    ate, n = ate_rmse(times, traj_p, times, tw.pose_batch(times)[0])
    assert np.isfinite(ate) and n > 30 and ate < 0.25, ate
