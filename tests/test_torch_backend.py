"""Parity of the port's IMU and back-end modules with the JAX package.

Both sides get the same numpy inputs (a window problem from
``lfvio_tpu.runtime.profiling.make_window_problem``, carried over with
``lfvio_tpu_torch.convert``) and run in float64 on the CPU. Unless a test
says otherwise the bound is 1e-9 (absolute, or relative to the quantity's
scale): both sides evaluate the same formulas, and only the summation
order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lfvio_tpu import backend as jb
from lfvio_tpu import imu as jimu
from lfvio_tpu.backend import gauge as jgauge
from lfvio_tpu.backend import marginalize as jmarg
from lfvio_tpu.backend import solver as jsolver
from lfvio_tpu.backend import triangulate as jtri
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch import imu as timu
from lfvio_tpu_torch.backend import factors as tfactors
from lfvio_tpu_torch.backend import gauge as tgauge
from lfvio_tpu_torch.backend import marginalize as tmarg
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.backend import triangulate as ttri

F64 = torch.float64


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def close(a, b, tol=1e-9):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(a).max()) if a.size else 1.0)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * scale, (err, scale)
    return err


@pytest.fixture(scope="module")
def problem():
    """A perturbed 32-feature window with tracks of 5 frames, td and
    extrinsics estimated, an informative prior whose residual is non-zero,
    and the preintegrations at the window's biases — JAX and torch forms."""
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(7)
    s = pb["state"]
    state = dataclasses.replace(
        s,
        p=s.p + 0.02 * rng.standard_normal(s.p.shape),
        ba=s.ba + 0.01 * rng.standard_normal(s.ba.shape),
        bg=s.bg + 0.001 * rng.standard_normal(s.bg.shape),
        td=jnp.asarray(0.003),
        tic=jnp.asarray([0.01, -0.02, 0.005]),
    )
    prior = dataclasses.replace(
        pb["prior"], r0=jnp.asarray(0.1 * rng.standard_normal(pb["prior"].r0.shape))
    )
    noise = pb["noise"]
    imu_raw = tuple(np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0"))
    pre = jax.jit(jax.vmap(
        lambda d, ac, gy, a0, g0, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a0, g0, ba, bg, noise)
    ))(*[jnp.asarray(x) for x in imu_raw], state.ba[:-1], state.bg[:-1])
    si, iv = jax.jit(jimu.whiten_covariance)(pre.covariance, jnp.asarray(pb["imu_valid"]))
    cfg = jb.SolverConfig(max_iterations=8)
    tn = convert.imu_noise(fields(noise))
    tstate = convert.window_state(fields(state))
    tpre = timu.preintegrate(*[t(x) for x in imu_raw], tstate.ba[:-1], tstate.bg[:-1], tn)
    tsi, tiv = timu.whiten_covariance(tpre.covariance, torch.as_tensor(np.asarray(pb["imu_valid"])))
    return dict(
        j=(state, pb["grid"], pre, si, iv, prior, pb["gravity"], cfg),
        t=(tstate, convert.feature_grid(fields(pb["grid"])), tpre, tsi, tiv,
           convert.prior_factor(fields(prior)), t(pb["gravity"]),
           convert.solver_config(dataclasses.asdict(cfg))),
        imu_raw=imu_raw, noise=noise, tnoise=tn,
    )


# ---------------------------------------------------------------- IMU
@pytest.mark.parametrize("form", ["sequential", "parallel"])
def test_preintegrate_matches_both_jax_forms(problem, form):
    """The port's log-depth preintegration against the JAX scan
    (sequential) and associative-scan (parallel) forms, on every window
    interval. Bound 1e-9: exact-arithmetic-equal forms, f64 rounding."""
    dts, accs, gyrs, a0, g0 = problem["imu_raw"]
    ba = np.full(3, 0.02)
    bg = np.full(3, -0.003)
    fn = jimu.preintegrate if form == "sequential" else jimu.preintegrate_parallel
    tp = timu.preintegrate(t(dts), t(accs), t(gyrs), t(a0), t(g0),
                           t(np.tile(ba, (len(dts), 1))), t(np.tile(bg, (len(dts), 1))),
                           problem["tnoise"])
    noise = problem["noise"]
    jp = jax.jit(jax.vmap(lambda d, ac, gy, a, g: fn(d, ac, gy, a, g, jnp.asarray(ba),
                                                       jnp.asarray(bg), noise)))(
        *[jnp.asarray(x) for x in (dts, accs, gyrs, a0, g0)])
    for name in ("delta_p", "delta_q", "delta_v", "jacobian", "covariance", "sum_dt"):
        close(getattr(jp, name), getattr(tp, name))


def test_padding_is_noop():
    """Zero-dt padding leaves every output unchanged (exactly, up to the
    log-depth reduction's order)."""
    rng = np.random.default_rng(3)
    noise = timu.ImuNoise(0.02, 0.01, 0.04, 0.001)
    dts = np.full(12, 0.005)
    accs = rng.standard_normal((12, 3)) + [0, 0, 9.81]
    gyrs = 0.3 * rng.standard_normal((12, 3))
    z = t(np.zeros(3))
    a = timu.preintegrate(t(dts), t(accs), t(gyrs), t(accs[0]), t(gyrs[0]), z, z, noise)
    pad = lambda x: np.concatenate([x, np.zeros((7,) + x.shape[1:])])
    b = timu.preintegrate(t(pad(dts)), t(pad(accs)), t(pad(gyrs)), t(accs[0]), t(gyrs[0]), z, z, noise)
    for name in ("delta_p", "delta_q", "delta_v", "jacobian", "covariance"):
        close(getattr(a, name).numpy(), getattr(b, name), 1e-12)


def test_bias_corrected_delta_and_residual(problem):
    st, _, pre, *_ , g, _ = problem["j"]
    tst, _, tpre, *_, tg, _ = problem["t"]
    jp0 = jax.tree_util.tree_map(lambda x: x[0], pre)
    dba, dbg = jnp.asarray([0.01, -0.02, 0.005]), jnp.asarray([0.001, 0.002, -0.001])
    ja = jimu.bias_corrected_delta(jp0, st.ba[0] + dba, st.bg[0] + dbg)
    ta = timu.bias_corrected_delta(tpre, tst.ba[:-1] + t(dba), tst.bg[:-1] + t(dbg))
    for x, y in zip(ja, ta):
        close(x, y[0])
    jr = jimu.imu_residual(jp0, st.p[0], st.q[0], st.v[0], st.ba[0], st.bg[0],
                           st.p[1], st.q[1], st.v[1], st.ba[1], st.bg[1], g)
    tr = timu.imu_residual(tpre, tst.p[:-1], tst.q[:-1], tst.v[:-1], tst.ba[:-1], tst.bg[:-1],
                           tst.p[1:], tst.q[1:], tst.v[1:], tst.ba[1:], tst.bg[1:], tg)
    close(jr, tr[0])


def test_whiten_covariance(problem):
    """S matches, and an invalid or non-PD covariance is zeroed and
    flagged on both sides (cholesky_ex in place of jnp's NaN)."""
    _, _, pre, si, iv, *_ = problem["j"]
    _, _, tpre, tsi, tiv, *_ = problem["t"]
    close(si, tsi, 1e-8)
    assert (np.asarray(iv) == tiv.numpy()).all()
    bad = np.array(pre.covariance)
    bad[1, 0, 0] = -1.0
    valid = np.ones(len(bad), bool)
    valid[2] = False
    js, jok = jimu.whiten_covariance(jnp.asarray(bad), jnp.asarray(valid))
    ts, tok = timu.whiten_covariance(t(bad), torch.as_tensor(valid))
    assert (np.asarray(jok) == tok.numpy()).all() and not tok[1] and not tok[2]
    close(js, ts, 1e-8)


def test_propagate_state_midpoint():
    rng = np.random.default_rng(5)
    args = [rng.standard_normal(3), np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]),
            rng.standard_normal(3), rng.standard_normal(3), rng.standard_normal(3),
            rng.standard_normal(3), rng.standard_normal(3), 0.005,
            0.01 * rng.standard_normal(3), 0.01 * rng.standard_normal(3), np.array([0, 0, 9.81])]
    ja = jimu.propagate_state_midpoint(*[jnp.asarray(a) for a in args])
    ta = timu.propagate_state_midpoint(*[t(a) for a in args])
    for x, y in zip(ja, ta):
        close(x, y)


# ------------------------------------------------------------- factors
def test_factor_residuals(problem):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    jr, jv = jax.jit(jb.projection_residuals_grid)(st, grid, jnp.asarray(cfg.proj_sqrt_info))
    tr, tv = tfactors.projection_residuals_grid(tst, tgrid, tcfg.proj_sqrt_info)
    assert (np.asarray(jv) == tv.numpy()).all()
    close(jr, tr)
    close(jax.jit(jb.imu_residuals_window)(st, pre, si, g, iv),
          tfactors.imu_residuals_window(tst, tpre, tsi, tg, tiv), 1e-8)
    close(jb.prior_residual(st, prior), tfactors.prior_residual(tst, tprior))


def test_triangulate_grid(problem):
    """Depths, not eigenvectors, are compared (the eigh sign cancels)."""
    st, grid, *_ = problem["j"]
    tst, tgrid, *_ = problem["t"]
    has = np.zeros(grid.used.shape, bool)
    has[::3] = True
    close(jax.jit(jtri.triangulate_grid)(st, grid, jnp.asarray(has)),
          ttri.triangulate_grid(tst, tgrid, torch.as_tensor(has)), 1e-8)


# -------------------------------------------------------------- solver
def test_linearization_rows(problem):
    """Whitened projection and IMU rows with their Jacobians in the full
    local layout (forward-mode on both sides)."""
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    ja = jax.jit(jsolver.linearize_proj_rows, static_argnums=2)(st, grid, cfg)
    ta = tsolver.linearize_proj_rows(tst, tgrid, tcfg)
    for i in (0, 1, 2, 4):
        close(ja[i], ta[i], 1e-8)
    jb_ = jax.jit(jsolver.linearize_imu_rows)(st, pre, si, iv, g)
    tb_ = tsolver.linearize_imu_rows(tst, tpre, tsi, tiv, tg)
    for x, y in zip(jb_, tb_):
        close(x, y, 1e-8)


def test_normal_equations_and_schur(problem):
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    ja = jax.jit(jsolver.assemble_normal_equations, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg)
    ta = tsolver.assemble_normal_equations(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    for x, y in zip(ja, ta):
        close(x, y, 1e-8)
    close(jax.jit(jsolver.total_cost, static_argnums=7)(st, grid, pre, si, iv, prior, g, cfg),
          tsolver.total_cost(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg), 1e-8)
    jdx = jsolver._schur_solve(*ja[:5], 1e-3, grid.used, jnp.float64)
    tdx = tsolver._schur_solve(*ta[:5], 1e-3, tgrid.used)
    for x, y in zip(jdx, tdx):
        close(x, y, 1e-7)


def test_schur_solve_non_pd_gives_non_finite_step():
    """A non-PD damped system yields a non-finite step (which lm_loop
    rejects), like jnp.linalg.cholesky's NaN, instead of raising."""
    D, Fn = 4, 2
    H = -torch.eye(D, dtype=F64)
    dx, dlam = tsolver._schur_solve(H, torch.zeros(D, Fn, dtype=F64),
                                    torch.ones(Fn, dtype=F64), torch.ones(D, dtype=F64),
                                    torch.ones(Fn, dtype=F64), 1e-4,
                                    torch.ones(Fn, dtype=torch.bool))
    assert not torch.isfinite(dx).all()


def test_lm_solve(problem):
    """Full LM over the perturbed window: same accept/reject sequence,
    states within 1e-7 (eight iterations of f64 linear solves)."""
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    jout, jc0, jc1, _ = jax.jit(jb.lm_solve, static_argnums=7)(
        st, grid, pre, si, iv, prior, g, cfg)
    tout, tc0, tc1, _ = tsolver.lm_solve(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    close(jc0, tc0, 1e-9)
    close(jc1, tc1, 1e-7)
    assert float(tc1) < float(tc0)
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth"):
        close(getattr(jout, name), getattr(tout, name), 1e-7)


def test_yaw_gauge_fix(problem):
    st, *_ = problem["j"]
    tst, *_ = problem["t"]
    op, oq = np.array([0.3, -0.2, 0.1]), np.array([0.95, 0.05, -0.1, 0.28])
    oq /= np.linalg.norm(oq)
    ja = jgauge.yaw_gauge_fix(st, jnp.asarray(op), jnp.asarray(oq))
    ta = tgauge.yaw_gauge_fix(tst, t(op), t(oq))
    for name in ("p", "q", "v"):
        close(getattr(ja, name), getattr(ta, name))


# -------------------------------------------------------- marginalization
def _info(prior):
    """Sign-free content of a square-root prior: JᵀJ, Jᵀr0, r0ᵀr0."""
    J = np.asarray(prior.J, np.float64)
    r = np.asarray(prior.r0, np.float64)
    return J.T @ J, J.T @ r, r @ r


@pytest.mark.parametrize("kind", ["old", "second_new"])
def test_marginalize_qr(problem, kind):
    """The QR priors agree in the information sense (R's row signs are the
    QR implementation's), and the x0 snapshots are identical."""
    st, grid, pre, si, iv, prior, g, cfg = problem["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = problem["t"]
    if kind == "old":
        jp = jax.jit(jmarg.marginalize_old_qr, static_argnums=7)(
            st, grid, pre, si, iv, prior, g, cfg)
        tp = tmarg.marginalize_old_qr(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    else:
        jp = jax.jit(jmarg.marginalize_second_new_qr, static_argnums=2)(st, prior, cfg)
        tp = tmarg.marginalize_second_new_qr(tst, tprior, tcfg)
    assert bool(jp.valid) and bool(tp.valid)
    tp_np = dataclasses.replace(tp, J=tp.J.numpy(), r0=tp.r0.numpy())
    for x, y in zip(_info(jp), _info(tp_np)):
        close(x, np.asarray(y), 1e-8)
    for name in ("x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg", "x0_tic", "x0_qic", "x0_td"):
        close(getattr(jp, name), getattr(tp, name), 1e-12)


def test_marginalize_second_new_qr_invalid_prior(problem):
    """An empty prior stays invalid (and zero) through SECOND_NEW."""
    tst, *_, tcfg = problem["t"]
    from lfvio_tpu_torch.backend.state import PriorFactor

    tp = tmarg.marginalize_second_new_qr(tst, PriorFactor.empty(F64), tcfg)
    assert not bool(tp.valid) and float(tp.J.abs().max()) == 0.0


# ------------------------------------------------- eigh marginalization
@pytest.fixture(scope="module")
def scene():
    """tests/test_backend.py's window (64 features anchored at frame 0, exact
    bearings and IMU) at the truth, in JAX and port form, with an
    informative prior whose residual is non-zero."""
    from tests.test_backend import G, make_scene, make_state, make_window_imu, project_to_grid

    p, v, q, pts_w, tic, qic = make_scene()
    grid, inv_depth = project_to_grid(p, q, pts_w, tic, qic, noise_px=0.5)
    pre, si = make_window_imu(p, v, q)
    state = make_state(p, v, q, tic, qic, inv_depth)
    D = jb.state.pose_dim(state.p.shape[0])
    rng = np.random.default_rng(2)
    A = rng.standard_normal((D, D))
    prior = jb.PriorFactor.from_state(jnp.asarray(np.linalg.cholesky(A @ A.T + D * np.eye(D)).T),
                                      jnp.asarray(0.1 * rng.standard_normal(D)), state)
    iv = jnp.ones((state.p.shape[0] - 1,), bool)
    cfg = jb.SolverConfig(estimate_td=False, estimate_extrinsic=False)
    tpre = timu.Preintegration(**{k: t(v_) for k, v_ in fields(pre).items()})
    return dict(j=(state, grid, pre, si, iv, prior, G, cfg),
                t=(convert.window_state(fields(state)), convert.feature_grid(fields(grid)), tpre,
                   t(si), torch.as_tensor(np.asarray(iv)), convert.prior_factor(fields(prior)),
                   t(G), convert.solver_config(dataclasses.asdict(cfg))))


@pytest.mark.parametrize("with_prior", [False, True])
def test_marginalize_old_eigh(scene, with_prior):
    """marginalize_old (H-space elimination, eigenvalue pseudo-inverse,
    S^{1/2}Vᵀ square root): JᵀJ and Jᵀr within 1e-8 of their scale of the
    JAX package's; the x0 snapshots identical."""
    st, grid, pre, si, iv, prior, g, cfg = scene["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = scene["t"]
    if not with_prior:
        prior, tprior = jb.PriorFactor.empty(jnp.float64), tmarg.PriorFactor.empty(F64)
    jp = jax.jit(jmarg.marginalize_old, static_argnums=7)(st, grid, pre, si, iv, prior, g, cfg)
    tp = tmarg.marginalize_old(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    assert bool(tp.valid)
    for x, y in zip(_info(jp), _info(dataclasses.replace(tp, J=tp.J.numpy(), r0=tp.r0.numpy()))):
        close(x, y, 1e-8)
    for name in ("x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg"):
        close(getattr(jp, name), getattr(tp, name), 1e-12)


def test_marginalize_second_new_eigh(scene):
    """marginalize_second_new on the MARGIN_OLD prior, evaluated at a moved
    state (a non-zero prior residual): information within 1e-8 of the JAX
    package's; float32 is refused."""
    st, grid, pre, si, iv, prior, g, cfg = scene["j"]
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = scene["t"]
    jold = jax.jit(jmarg.marginalize_old, static_argnums=7)(st, grid, pre, si, iv, prior, g, cfg)
    told = tmarg.marginalize_old(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    rng = np.random.default_rng(9)
    dp = 0.01 * rng.standard_normal(st.p.shape)
    jst = dataclasses.replace(st, p=st.p + dp)
    tst = tst.replace(p=tst.p + t(dp))
    jp = jax.jit(jmarg.marginalize_second_new, static_argnums=2)(jst, jold, cfg)
    tp = tmarg.marginalize_second_new(tst, told, tcfg)
    for x, y in zip(_info(jp), _info(dataclasses.replace(tp, J=tp.J.numpy(), r0=tp.r0.numpy()))):
        close(x, y, 1e-8)
    for name in ("x0_p", "x0_q", "x0_v"):
        close(getattr(jp, name), getattr(tp, name), 1e-12)
    f32 = dataclasses.replace(told, J=told.J.float())
    with pytest.raises(TypeError, match="float64"):
        tmarg.marginalize_second_new(tst, f32, tcfg)


def test_eigh_and_qr_priors_agree(scene):
    """The port's two MARGIN_OLD forms carry the same information (the
    bound of tests/test_marg_qr.py, 2e-6 of the scale)."""
    tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg = scene["t"]
    e = tmarg.marginalize_old(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    q = tmarg.marginalize_old_qr(tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg)
    for x, y in zip(_info(e), _info(q)):
        close(x, y, 2e-6)
