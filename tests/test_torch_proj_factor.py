"""The port's projection factor (``factors.projection_jacobian``, the plain
versions in ``backend/proj_cuda.py`` that the CPU runs, and the solver
functions over them) against the JAX package's forward-mode linearization,
on the CPU in float64.

Each case feeds the same numpy inputs to JAX's jitted ``linearize_projection``
/ ``linearize_proj_rows`` / ``assemble_normal_equations`` / ``total_cost``
and to the port's. The bound is 1e-10 of each output's scale (its largest
magnitude, at least 1): the analytic Jacobian and forward-mode autodiff
agree to a few roundings (1e-15 relative), and the sums differ only in
their order. ``projection_jacobian`` is also held against
``torch.func.jacfwd`` of ``projection_residual`` on the same inputs.

The cases: tests/test_torch_backend.py's window (32 slots, tracks of 5
frames from varied anchors, td and extrinsics estimated); the same with
both estimate flags off; a two-camera window built from numpy whose
tracks mix cameras (anchor and observer on different cameras); and a
window of 20 (21 frames) at 40 slots built from numpy, with anchors up to
frame 18, features with |λ| < 1e-8 (positive and negative), an unused
slot and tracks with invalid frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

torch.set_num_threads(1)

from lfvio_tpu import backend as jb
from lfvio_tpu import imu as jimu
from lfvio_tpu.backend import solver as jsolver
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch import imu as timu
from lfvio_tpu_torch.backend import factors as tfactors
from lfvio_tpu_torch.backend import proj_cuda
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.geom import quat_mul, so3_exp, tangent_basis

F64 = torch.float64
TOL = 1e-10
CASES = ("backend", "flags_off", "dual", "window20")


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


def _quat(theta):
    """Unit quaternions [..., 4] (wxyz) of rotation vectors [..., 3]."""
    ang = np.linalg.norm(theta, axis=-1, keepdims=True)
    axis = theta / np.maximum(ang, 1e-300)
    return np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis], -1)


def _mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def numpy_window(seed, F, W1, n_cams):
    """A window built from numpy: W1 frames along a curve, n_cams
    extrinsics, F landmarks seen from their anchor on (tracks of varied
    length with dropped frames), bearings with 1e-3 noise, a prior over the
    whole layout whose residual is non-zero, W1 - 1 IMU intervals of 8
    samples. Slots 0 and 1 have |λ| < 1e-8, slot 2 is unused."""
    rng = np.random.default_rng(seed)
    C = n_cams
    tt = np.linspace(0.0, 0.1 * (W1 - 1), W1)
    p = np.stack([tt, 0.2 * np.sin(tt), 0.1 * tt], -1) + 0.01 * rng.standard_normal((W1, 3))
    q = _quat(np.stack([0.05 * np.sin(3 * tt), 0.1 * tt, 0.1 * np.cos(2 * tt)], -1))
    tic = 0.03 * rng.standard_normal((C, 3))
    qic = _quat(0.02 * rng.standard_normal((C, 3)))
    X = p.mean(0) + rng.standard_normal((F, 3)) * 3.0
    anchor = rng.integers(0, W1 - 2, F)
    valid = np.zeros((F, W1), bool)
    for f in range(F):
        end = min(W1, anchor[f] + rng.integers(2, W1 + 1))
        valid[f, anchor[f]:end] = True
        valid[f, anchor[f] + 1:end] &= rng.random(end - anchor[f] - 1) > 0.2
    cam = rng.integers(0, C, (F, W1))
    R, Rc = _mat(q), _mat(qic)
    Pb = np.einsum("jba,fjb->fja", R, X[:, None] - p[None])  # R_jᵀ (X - p_j)
    Pc = np.einsum("fjba,fjb->fja", Rc[cam], Pb - tic[cam])
    bearing = Pc / np.linalg.norm(Pc, axis=-1, keepdims=True)
    bearing += 1e-3 * rng.standard_normal(bearing.shape)
    bearing /= np.linalg.norm(bearing, axis=-1, keepdims=True)
    inv_depth = 1.0 / np.linalg.norm(Pc[np.arange(F), anchor], axis=-1)
    inv_depth *= rng.uniform(0.95, 1.05, F)
    inv_depth[0], inv_depth[1] = 5e-9, -4e-9
    used = np.ones(F, bool)
    used[2] = False
    mono = C == 1
    state = jb.WindowState(
        p=p, q=q, v=0.1 * rng.standard_normal((W1, 3)), ba=0.01 * rng.standard_normal((W1, 3)),
        bg=0.001 * rng.standard_normal((W1, 3)), tic=tic[0] if mono else tic,
        qic=qic[0] if mono else qic, td=np.asarray(0.003), inv_depth=inv_depth)
    grid = jb.FeatureGrid(
        bearing=bearing, velocity=0.01 * rng.standard_normal((F, W1, 3)),
        td_obs=0.002 * rng.standard_normal((F, W1)), valid=valid,
        anchor=anchor.astype(np.int32), used=used, cam=None if mono else cam.astype(np.int32))
    D = 15 * W1 + 6 * C + 1
    x0 = dataclasses.replace(state, p=p + 0.01 * rng.standard_normal(p.shape),
                             td=np.asarray(0.001))
    prior = jb.PriorFactor.from_state(np.triu(0.5 * rng.standard_normal((D, D))) + 2 * np.eye(D),
                                      0.1 * rng.standard_normal(D), x0)
    S = 8
    imu = dict(dts=np.full((W1 - 1, S), 0.1 / S),
               accs=np.array([0.0, 0.0, 9.81]) + 0.1 * rng.standard_normal((W1 - 1, S, 3)),
               gyrs=0.05 * rng.standard_normal((W1 - 1, S, 3)))
    imu["a0"], imu["g0"] = imu["accs"][:, 0].copy(), imu["gyrs"][:, 0].copy()
    as_j = lambda obj: jax.tree_util.tree_map(jnp.asarray, obj)
    return dict(state=as_j(state), grid=as_j(grid), prior=as_j(prior), imu=imu,
                imu_valid=np.ones(W1 - 1, bool), gravity=np.array([0.0, 0.0, 9.81]),
                noise=jimu.ImuNoise(0.02, 0.01, 0.04, 0.001),
                cfg=jb.SolverConfig(max_iterations=8, n_cams=C))


def backend_window():
    """tests/test_torch_backend.py's problem: make_window_problem(32) with
    tracks of 5 frames, perturbed, td and extrinsics estimated."""
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(7)
    s = pb["state"]
    state = dataclasses.replace(
        s, p=s.p + 0.02 * rng.standard_normal(s.p.shape),
        ba=s.ba + 0.01 * rng.standard_normal(s.ba.shape),
        bg=s.bg + 0.001 * rng.standard_normal(s.bg.shape),
        td=jnp.asarray(0.003), tic=jnp.asarray([0.01, -0.02, 0.005]))
    prior = dataclasses.replace(
        pb["prior"], r0=jnp.asarray(0.1 * rng.standard_normal(pb["prior"].r0.shape)))
    return dict(state=state, grid=pb["grid"], prior=prior,
                imu={k: np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0")},
                imu_valid=np.asarray(pb["imu_valid"]), gravity=np.asarray(pb["gravity"]),
                noise=pb["noise"], cfg=jb.SolverConfig(max_iterations=8))


_cache = {}


def case(name):
    """(JAX arguments, port arguments) of assemble_normal_equations for the
    case: (state, grid, pre, sqrt_info, imu_valid, prior, gravity, cfg)."""
    if name in _cache:
        return _cache[name]
    if name in ("backend", "flags_off"):
        c = backend_window()
        if name == "flags_off":
            c["cfg"] = dataclasses.replace(c["cfg"], estimate_td=False, estimate_extrinsic=False)
    elif name == "dual":
        c = numpy_window(3, 24, 11, 2)
    else:
        c = numpy_window(5, 40, 21, 1)
    st, noise, imu = c["state"], c["noise"], c["imu"]
    raw = [imu[k] for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = jax.jit(jax.vmap(
        lambda d, ac, gy, a0, g0, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a0, g0, ba, bg, noise)
    ))(*[jnp.asarray(x) for x in raw], st.ba[:-1], st.bg[:-1])
    si, iv = jax.jit(jimu.whiten_covariance)(pre.covariance, jnp.asarray(c["imu_valid"]))
    tst = convert.window_state(fields(st))
    tpre = timu.preintegrate(*[t(x) for x in raw], tst.ba[:-1], tst.bg[:-1],
                             convert.imu_noise(fields(noise)))
    tsi, tiv = timu.whiten_covariance(tpre.covariance, torch.as_tensor(c["imu_valid"]))
    cfg = c["cfg"]
    out = ((st, c["grid"], pre, si, iv, c["prior"], jnp.asarray(c["gravity"]), cfg),
           (tst, convert.feature_grid(fields(c["grid"])), tpre, tsi, tiv,
            convert.prior_factor(fields(c["prior"])), t(c["gravity"]),
            convert.solver_config(dataclasses.asdict(cfg))))
    _cache[name] = out
    return out


def test_cases_cover_what_they_claim():
    """The cases hold what the module docstring says they do."""
    j_dual = case("dual")[0][1]
    g = case("window20")[1][1]
    cam, anchor = np.asarray(j_dual.cam), np.asarray(j_dual.anchor)
    valid = np.asarray(j_dual.valid)
    cam_i = cam[np.arange(len(anchor)), anchor][:, None]
    assert (valid & (cam != cam_i)).any() and (valid & (cam == cam_i)).any()
    assert g.valid.shape == (40, 21) and int(g.anchor.max()) > 10
    st = case("window20")[1][0]
    assert (st.inv_depth.abs() < 1e-8).sum() == 2 and not bool(g.used[2])
    gb = case("backend")[1][1]
    assert int(gb.anchor.max()) > 0 and not bool(gb.valid.all())
    runs = g.valid.sum(1)
    span = torch.stack([torch.nonzero(v).max() - torch.nonzero(v).min() + 1 for v in g.valid])
    assert bool((runs < span).any())  # invalid frames inside tracks


@pytest.mark.parametrize("name", CASES)
def test_linearize_projection(name):
    (st, grid, *_, cfg), (tst, tgrid, *_, tcfg) = case(name)
    ja = jax.jit(jsolver.linearize_projection, static_argnums=2)(st, grid, cfg)
    ta = tsolver.linearize_projection(tst, tgrid, tcfg)
    assert (np.asarray(ja[2]) == ta[2].numpy()).all()
    for i in (0, 1, 3):
        close(ja[i], ta[i])


@pytest.mark.parametrize("name", CASES)
def test_linearize_proj_rows(name):
    (st, grid, *_, cfg), (tst, tgrid, *_, tcfg) = case(name)
    ja = jax.jit(jsolver.linearize_proj_rows, static_argnums=2)(st, grid, cfg)
    ta = tsolver.linearize_proj_rows(tst, tgrid, tcfg)
    assert (np.asarray(ja[3]) == ta[3].numpy()).all()
    for i in (0, 1, 2, 4):
        close(ja[i], ta[i])


@pytest.mark.parametrize("name", CASES)
def test_assemble_normal_equations(name):
    j, tt_ = case(name)
    ja = jax.jit(jsolver.assemble_normal_equations, static_argnums=7)(*j)
    ta = tsolver.assemble_normal_equations(*tt_)
    for x, y in zip(ja, ta):
        close(x, y)


@pytest.mark.parametrize("name", CASES)
def test_normal_plain_is_the_assembled_rows(name):
    """``proj_normal``'s plain version, which its wrapper runs on CPU
    tensors, equals ``assemble_plain`` of ``rows_plain`` and its cost terms
    bit for bit."""
    _, (st, grid, *_, cfg) = case(name)
    C = 1 if st.tic.ndim == 1 else st.tic.shape[0]
    rows = proj_cuda.rows_plain(st, grid, cfg)
    want = (*proj_cuda.assemble_plain(grid, rows, cfg, C), rows[3])
    for got in (proj_cuda.normal_plain(st, grid, cfg, C), proj_cuda.proj_normal(st, grid, cfg, C)):
        assert len(got) == 6 and all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("name", CASES)
def test_total_cost(name):
    j, tt_ = case(name)
    close(jax.jit(jsolver.total_cost, static_argnums=7)(*j), tsolver.total_cost(*tt_))


@pytest.mark.parametrize("name", CASES)
def test_projection_jacobian_against_jacfwd(name):
    """The rows' analytic Jacobian against forward-mode autodiff of
    ``projection_residual`` over the 26 tangents, on every observation the
    mask keeps (the λ column is 0 where |λ| < 1e-8 on both sides)."""
    _, (st, grid, *_, cfg) = case(name)
    F, W1 = grid.valid.shape
    p_i, q_i, pts_i, vel_i, tdo_i = tfactors.anchor_values(st, grid)
    tic_i, qic_i, tic_j, qic_j = tfactors.obs_extrinsics(st, grid)
    per_obs = lambda x, k: (x[:, None] if k == "f" else x[None]).expand(
        F, W1, *x.shape[1:]).reshape(F * W1, *x.shape[1:])
    args = (per_obs(p_i, "f"), per_obs(q_i, "f"), per_obs(st.p, "w"), per_obs(st.q, "w"),
            per_obs(tic_i, "f"), per_obs(qic_i, "f"), tic_j.reshape(-1, 3), qic_j.reshape(-1, 4),
            per_obs(st.inv_depth, "f"), per_obs(pts_i, "f"), grid.bearing.reshape(-1, 3),
            per_obs(vel_i, "f"), grid.velocity.reshape(-1, 3), per_obs(tdo_i, "f"),
            grid.td_obs.reshape(-1), tangent_basis(grid.bearing).reshape(-1, 2, 3))

    def local(d, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, lam, pts_i, pts_j, vel_i,
              vel_j, tdo_i, tdo_j, tb):
        r = tfactors.projection_residual(
            p_i + d[0:3], quat_mul(q_i, so3_exp(d[3:6])),
            p_j + d[6:9], quat_mul(q_j, so3_exp(d[9:12])),
            tic_i + d[12:15], quat_mul(qic_i, so3_exp(d[15:18])),
            tic_j + d[18:21], quat_mul(qic_j, so3_exp(d[21:24])),
            lam + d[24], st.td + d[25], pts_i, pts_j, vel_i, vel_j, tdo_i, tdo_j, tb,
            cfg.proj_sqrt_info)
        return r, r

    J_ad, r_ad = vmap(jacfwd(local, has_aux=True), in_dims=(None,) + (0,) * len(args))(
        torch.zeros(26, dtype=F64), *args)
    keep = tfactors.residual_mask(grid)
    res, J26, w, cost = proj_cuda.rows_plain(st, grid, cfg)
    close(torch.where(keep[..., None], r_ad.reshape(F, W1, 2), 0.0).numpy(), res)
    close(torch.where(keep[..., None, None], J_ad.reshape(F, W1, 2, 26), 0.0).numpy(), J26)
    assert bool(torch.isfinite(J26).all()) and bool((w[~keep] == 1).all())
    assert bool((cost[~keep] == 0).all())


@pytest.mark.parametrize("name", ["proj_rows", "proj_cost"])
def test_latency_floor_is_card_only(name):
    """``proj_cuda.latency_floor`` times a launch of the empty kernel on the
    card: on CPU inputs it raises, as it does for a launch it does not take
    ("proj_normal"), and it adds to no wrapper's ``launches``."""
    _, (st, grid, *_, cfg) = case("dual")
    kernels = (proj_cuda.proj_rows, proj_cuda.proj_cost, proj_cuda.proj_normal)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="on the card"):
        proj_cuda.latency_floor(name, st, grid, cfg)
    with pytest.raises(ValueError, match="proj_rows' or 'proj_cost"):
        proj_cuda.latency_floor("proj_normal", st, grid, cfg)
    assert [k.launches for k in kernels] == before
