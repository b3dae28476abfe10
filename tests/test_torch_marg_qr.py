"""The marginalizations' QR in two stages (backend/marg_cuda.py's plain
versions of csrc/marg_qr.cu: each anchored feature's inverse depth removed
within its own rows, then one R factor over the pose columns) against the
JAX package's QR marginalizations, and against the port's earlier dense form
(one QR of the whole stacked matrix, the depth columns an F x F expansion,
unit rows in the empty dropped columns), kept here as the oracle.

On the CPU in f64. JᵀJ, Jᵀr and rᵀr of a prior are compared, not J: R's
row signs are the implementation's. Bounds: 1e-8 of the scale against JAX
(test_torch_backend.py's marginalization bound), 1e-10 against the dense
form (the same factorization up to rounding), 1e-12 where only the order of
rows or padding differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import chip_smoke

from lfvio_tpu import backend as jb
from lfvio_tpu import imu as jimu
from lfvio_tpu.backend import marginalize as jmarg
from lfvio_tpu.backend.state import NFRAMES
from lfvio_tpu.runtime.profiling import make_window_problem

from lfvio_tpu_torch import convert
from lfvio_tpu_torch import imu as timu
from lfvio_tpu_torch.backend import marg_cuda as mc
from lfvio_tpu_torch.backend import marginalize as tmarg
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.backend.state import PriorFactor, pose_dim

F64 = torch.float64


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def info(prior):
    """JᵀJ, Jᵀr0, r0ᵀr0 of a prior (either package's) in numpy f64."""
    J = np.asarray(prior.J.numpy() if isinstance(prior.J, torch.Tensor) else prior.J, np.float64)
    r = np.asarray(prior.r0.numpy() if isinstance(prior.r0, torch.Tensor) else prior.r0,
                   np.float64)
    return J.T @ J, J.T @ r, r @ r


def info_close(a, b, tol, singular=False, with_rr=True):
    """Each of the three within ``tol`` of its scale (at least 1). Where
    JᵀJ is singular (``singular``: no prior, so kept columns without any
    information) r0ᵀr0 is not a function of JᵀJ and Jᵀr: a QR that gives an
    empty column a row of R moves a part of the residual into it, which
    the one it is compared with may not. There r0ᵀr0 of ``b`` (the port's
    two stages) must be the minimum-norm one, (Jᵀr)ᵀ (JᵀJ)⁺ (Jᵀr), as the
    eigh form's is: an empty column consumes no row; within 1e-8 at the
    least, the rounding of the pseudo-inverse of that singular JᵀJ.
    ``with_rr`` False leaves r0ᵀr0 out."""
    pairs = [(x, y, tol) for x, y in zip(info(a), info(b))][:3 if with_rr else 2]
    if singular:
        H, g, rr = info(b)
        pairs[2] = (g @ np.linalg.pinv(H, rcond=1e-12, hermitian=True) @ g, rr, max(tol, 1e-8))
    for x, y, bound in pairs:
        x, y = np.asarray(x), np.asarray(y)
        scale = max(1.0, float(np.abs(x).max()))
        assert float(np.abs(x - y).max()) <= bound * scale, (float(np.abs(x - y).max()), scale)


def _small_quat(rng, angle):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    return np.r_[np.cos(angle / 2), np.sin(angle / 2) * axis]


def window(n_cams, with_prior, seed=7):
    """make_window_problem's 32-slot window (tracks of 5 frames, anchors
    spread over the window), perturbed, td and extrinsics estimated; with
    ``n_cams`` = 2 a second extrinsic and a random camera per observation;
    the prior informative with a non-zero residual, or empty (the first
    marginalization: nothing ties pose0's gauge directions). JAX and port
    forms, the MARGIN_OLD arguments without the config, and each config."""
    pb = make_window_problem(32, jnp.float64, n_obs_frames=5, imu_samples=16)
    rng = np.random.default_rng(seed)
    s = pb["state"]
    kw = {}
    grid = pb["grid"]
    if n_cams == 2:
        kw = dict(tic=jnp.asarray([[0.01, -0.02, 0.005], [-0.015, 0.03, -0.04]]),
                  qic=jnp.asarray(np.stack([_small_quat(rng, 0.01), _small_quat(rng, 0.02)])))
        cam = rng.integers(0, 2, (s.inv_depth.shape[0], NFRAMES)).astype(np.int32)
        grid = dataclasses.replace(grid, cam=jnp.asarray(cam))
    else:
        kw = dict(tic=jnp.asarray([0.01, -0.02, 0.005]))
    state = dataclasses.replace(
        s, p=s.p + 0.02 * rng.standard_normal(s.p.shape),
        ba=s.ba + 0.01 * rng.standard_normal(s.ba.shape),
        bg=s.bg + 0.001 * rng.standard_normal(s.bg.shape), td=jnp.asarray(0.003), **kw)
    D = pose_dim(NFRAMES, n_cams)
    if with_prior:
        x0 = dataclasses.replace(state, p=state.p + 0.01 * rng.standard_normal(state.p.shape))
        prior = jb.PriorFactor.from_state(
            jnp.asarray(np.triu(0.5 * rng.standard_normal((D, D))) + 2.0 * np.eye(D)),
            jnp.asarray(0.1 * rng.standard_normal(D)), x0)
    else:
        prior = jb.PriorFactor.empty(jnp.float64, NFRAMES, n_cams)
    noise = pb["noise"]
    imu_raw = tuple(np.asarray(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0"))
    pre = jax.jit(jax.vmap(
        lambda d, ac, gy, a0, g0, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a0, g0, ba, bg, noise)
    ))(*[jnp.asarray(x) for x in imu_raw], state.ba[:-1], state.bg[:-1])
    si, iv = jax.jit(jimu.whiten_covariance)(pre.covariance, jnp.asarray(pb["imu_valid"]))
    cfg = jb.SolverConfig(max_iterations=8, n_cams=n_cams)
    tst = convert.window_state(fields(state))
    tpre = timu.preintegrate(*[t(x) for x in imu_raw], tst.ba[:-1], tst.bg[:-1],
                             convert.imu_noise(fields(noise)))
    tsi, tiv = timu.whiten_covariance(tpre.covariance,
                                      torch.as_tensor(np.asarray(pb["imu_valid"])))
    tprior = (convert.prior_factor(fields(prior)) if with_prior
              else PriorFactor.empty(F64, NFRAMES, n_cams=n_cams))
    return dict(j=(state, grid, pre, si, iv, prior, pb["gravity"]), jcfg=cfg,
                t=(tst, convert.feature_grid(fields(grid)), tpre, tsi, tiv, tprior,
                   t(pb["gravity"])),
                tcfg=convert.solver_config(dataclasses.asdict(cfg)))


CASES = {f"{'mono' if nc == 1 else 'two_cameras'}_{'prior' if p else 'no_prior'}": (nc, p)
         for nc in (1, 2) for p in (True, False)}


@pytest.fixture(scope="module")
def windows():
    return {k: window(*v) for k, v in CASES.items()}


@pytest.fixture(scope="module")
def jax_priors(windows):
    """JAX's marginalize_old_qr and marginalize_second_new_qr of each
    window, recorded once (one jit of each function) for every test that
    compares with them."""
    old = jax.jit(jmarg.marginalize_old_qr, static_argnums=7)
    new = jax.jit(jmarg.marginalize_second_new_qr, static_argnums=2)
    return {k: {"old": old(*w["j"], w["jcfg"]), "new": new(w["j"][0], w["j"][5], w["jcfg"])}
            for k, w in windows.items()}


# -------------------------------------------- the earlier dense form (oracle)
def dense_old_qr(*args):
    """The port's MARGIN_OLD before the two stages: one QR
    (torch.linalg.qr) of [pose0/sb0 | the F depth columns | kept | r] with
    a unit row in each empty dropped column (chip_smoke.py's copy, which
    phase 14 times as the form the two stages replaced)."""
    return chip_smoke.dense_marginalize_old_qr(args)


def dense_second_new_qr(state, prior, cfg):
    """The port's SECOND_NEW before: one QR of [pose[W-1] | kept | r] with
    unit rows in the empty pose[W-1] columns."""
    n_frames = prior.x0_p.shape[0]
    D = prior.J.shape[0]
    rp = tmarg.prior_residual(state, prior)
    J0 = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    drop, keep, _ = tmarg._indices("second_new", n_frames, D, J0.device)
    K = len(keep)
    A = torch.cat([J0[:, drop], J0[:, keep], rp[:, None]], dim=1)
    Rfac = torch.linalg.qr(tmarg._with_unit_rows(A, len(drop)), mode="r")[1]
    Jk, rk = Rfac[6:6 + K, 6:6 + K], Rfac[6:6 + K, 6 + K]
    ok = prior.valid & torch.isfinite(Jk).all() & torch.isfinite(rk).all()
    J, r0 = tmarg._scatter_prior(torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), keep, D)
    return tmarg._slid_second_new(J, r0, state, ok)


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("case", list(CASES))
def test_marginalize_old_qr_matches_jax(windows, jax_priors, case):
    """MARGIN_OLD mono and two-camera, with an informative prior and with
    none (the first marginalization, pose0's gauge directions untied):
    JᵀJ, Jᵀr and rᵀr within 1e-8 of JAX's marginalize_old_qr (without a
    prior, rᵀr the minimum-norm one: ``info_close``); the x0 snapshots
    identical."""
    w = windows[case]
    jp = jax_priors[case]["old"]
    tp = tmarg.marginalize_old_qr(*w["t"], w["tcfg"])
    assert bool(jp.valid) and bool(tp.valid)
    info_close(jp, tp, 1e-8, singular="no_prior" in case)
    for name in ("x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg", "x0_tic", "x0_qic", "x0_td"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)), getattr(tp, name).numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", [k for k in CASES if k.endswith("_prior") and "no_" not in k])
def test_marginalize_second_new_qr_matches_jax(windows, jax_priors, case):
    """SECOND_NEW of the informative prior at the moved state (a non-zero
    prior residual), mono and two-camera: within 1e-8 of JAX's
    marginalize_second_new_qr."""
    w = windows[case]
    tst, tprior = w["t"][0], w["t"][5]
    jp = jax_priors[case]["new"]
    tp = tmarg.marginalize_second_new_qr(tst, tprior, w["tcfg"])
    assert bool(jp.valid) and bool(tp.valid)
    info_close(jp, tp, 1e-8)
    for name in ("x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)), getattr(tp, name).numpy(),
                                   rtol=0, atol=1e-12)


def test_marginalize_second_new_qr_of_an_empty_prior(windows, jax_priors):
    """An invalid (empty) prior stays invalid and zero through SECOND_NEW,
    as in JAX's form."""
    w = windows["mono_no_prior"]
    jp = jax_priors["mono_no_prior"]["new"]
    tp = tmarg.marginalize_second_new_qr(w["t"][0], w["t"][5], w["tcfg"])
    assert not bool(jp.valid) and not bool(tp.valid)
    assert float(tp.J.abs().max()) == 0.0 and float(tp.r0.abs().max()) == 0.0


# ------------------------------------------- against the earlier dense form
@pytest.fixture(scope="module")
def empty_cols():
    """test_torch_backend.py's empty-column inputs: tests/_torch_dist_child's
    mixed problem (features anchored at frame 0 beside others, so the dense
    form's depth columns include empty ones) and its prior with the
    pose[W-1] columns zeroed (what a SECOND_NEW leaves)."""
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from tests import _torch_dist_child as child

    pb = child.problem(mixed=True)
    state, grid, prior, gravity, cfg = (pb[k] for k in ("state", "grid", "prior", "gravity", "cfg"))
    pre = preintegrate(*pb["imu"], state.ba[:-1], state.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, pb["imu_valid"])
    o = tmarg.pose_off(state.p.shape[0] - 2)
    J = prior.J.clone()
    J[:, o:o + 6] = 0.0
    return dict(old=(state, grid, pre, si, ok, prior, gravity, cfg),
                second_new=(state, dataclasses.replace(prior, J=J), cfg))


@pytest.mark.parametrize("kind", ["old", "second_new"])
def test_two_stages_match_the_dense_form_on_empty_columns(empty_cols, kind):
    """Where the dense form needs its unit rows (empty depth columns of
    features not anchored at frame 0; empty pose[W-1] columns after a
    SECOND_NEW), the two stages give the same prior within 1e-10."""
    args = empty_cols[kind]
    if kind == "old":
        ref, got = dense_old_qr(*args), tmarg.marginalize_old_qr(*args)
    else:
        ref, got = dense_second_new_qr(*args), tmarg.marginalize_second_new_qr(*args)
    assert bool(ref.valid) and bool(got.valid)
    info_close(ref, got, 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_two_stages_match_the_dense_form(windows, case):
    """On the JAX comparison's windows too, within 1e-10 (without a prior,
    rᵀr the minimum-norm one)."""
    w = windows[case]
    info_close(dense_old_qr(*w["t"], w["tcfg"]), tmarg.marginalize_old_qr(*w["t"], w["tcfg"]),
               1e-10, singular="no_prior" in case)


# ------------------------------------------------- padding, order, stage 1
def _padded(state, grid, extra):
    """``extra`` unused, unobserved slots appended to the grid and the
    depths."""
    pad = lambda x, v=0: torch.cat([x, torch.full((extra,) + x.shape[1:], v, dtype=x.dtype)])
    grid = grid.replace(bearing=pad(grid.bearing, 0.5), velocity=pad(grid.velocity),
                        td_obs=pad(grid.td_obs), valid=pad(grid.valid, False),
                        anchor=pad(grid.anchor), used=pad(grid.used, False),
                        cam=None if grid.cam is None else pad(grid.cam))
    return state.replace(inv_depth=pad(state.inv_depth, 0.3)), grid


@pytest.mark.parametrize("case", ["mono_prior", "two_cameras_no_prior"])
def test_zero_padded_slots_leave_the_prior_unchanged(windows, case):
    """Eight unused slots more (each keeps its 2 W zero rows): the same
    prior within 1e-12."""
    w = windows[case]
    st, grid, *rest = w["t"]
    pst, pgrid = _padded(st, grid, 8)
    info_close(tmarg.marginalize_old_qr(st, grid, *rest, w["tcfg"]),
               tmarg.marginalize_old_qr(pst, pgrid, *rest, w["tcfg"]), 1e-12)


@pytest.mark.parametrize("case", ["mono_prior", "two_cameras_no_prior"])
def test_shuffled_rows_leave_the_r_factor_unchanged(windows, case):
    """marg_qr of MARGIN_OLD's stack with its rows shuffled: the same RᵀR
    within 1e-12 of the scale, and the same information below the 15
    dropped rows (the prior's)."""
    w = windows[case]
    A = tmarg.old_stack(*w["t"], w["tcfg"])
    R = mc.marg_qr(A)
    Rs = mc.marg_qr(A[torch.randperm(A.shape[0], generator=torch.Generator().manual_seed(0))])
    scale = float((A.abs().T @ A.abs()).max())
    assert float((R.T @ R - A.T @ A).abs().max()) <= 1e-12 * scale
    assert float((Rs.T @ Rs - R.T @ R).abs().max()) <= 1e-12 * scale
    kept = lambda M: M[15:-1, 15:].T @ M[15:-1, 15:]
    assert float((kept(Rs) - kept(R)).abs().max()) <= 1e-12 * float(kept(R).abs().max())


@pytest.mark.parametrize("case", list(CASES))
def test_depth_stage_is_each_features_schur_complement(windows, case):
    """marg_depth's rows of each slot: their information is the slot's
    dense rows' with its depth Schur-eliminated (AᵀA - Aᵀx xᵀA / xᵀx) within
    1e-12; the dropped row's slot is zero; a slot whose depth column is zero
    keeps its rows as they are."""
    w = windows[case]
    st, grid = w["t"][:2]
    cfg = w["tcfg"]
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res, J26, wts, _ = tsolver.proj_rows(st, grid0, cfg)
    nc = tmarg.n_cams_of(st)
    A, x = mc._dense_obs_rows(res, J26, wts, grid0, cfg, nc)
    F, R2, C = A.shape
    out = mc.marg_depth(res, J26, wts, grid0, cfg, nc).reshape(F, R2, C)
    n_reflected = 0
    for f in range(F):
        H = A[f].T @ A[f]
        xx = float(x[f] @ x[f])
        if xx == 0:
            assert torch.equal(out[f], A[f])
            continue
        n_reflected += 1
        u = A[f].T @ x[f]
        want = H - torch.outer(u, u) / xx
        assert float(out[f, 0].abs().max()) == 0.0
        assert float((out[f].T @ out[f] - want).abs().max()) <= 1e-12 * float(H.abs().max())
    assert 0 < n_reflected < F


def test_qr_skips_empty_columns_without_losing_rows():
    """marg_qr of a matrix with two empty columns: RᵀR = AᵀA within 1e-13
    of the scale, their rows of R zero, and the information below them the
    dense form's with unit rows (torch.linalg.qr of _with_unit_rows) within
    1e-12: an empty column consumes no row."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 8))
    A[:, [1, 5]] = 0.0
    A = torch.as_tensor(A)
    R = mc.marg_qr(A)
    assert float((R.T @ R - A.T @ A).abs().max()) <= 1e-13 * float((A.T @ A).abs().max())
    assert float(R[1].abs().max()) == 0.0 and float(R[5].abs().max()) == 0.0
    assert float(torch.tril(R, -1).abs().max()) == 0.0
    for m in (2, 6):
        ref = torch.linalg.qr(tmarg._with_unit_rows(A, m), mode="r")[1][m:, m:]
        got = R[m:, m:]
        assert float((got.T @ got - ref.T @ ref).abs().max()) <= 1e-12 * float((A.T @ A).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["mono_prior", "two_cameras_no_prior"])
def test_marg_check_rejects_planted_faults(windows, case, dtype):
    """chip_smoke.py phase 14's check of the marginalization kernels, run on
    the CPU (where each wrapper is its plain version, so kernel and plain
    agree exactly and repeat bit for bit): every planted fault of
    MARG_FAULTS exceeds MARG_BOUNDS, at MARGIN_OLD's stages and (where
    there is a prior) SECOND_NEW's stack; the kept information within its
    bound (in f32 against the plain version run in f64)."""
    w = windows[case]
    args = chip_smoke.to_f64(tuple(w["t"])) + (w["tcfg"],)
    if dtype == torch.float32:
        args = tuple(x.float() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                     for x in args)
        args = tuple(dataclasses.replace(x, **{f.name: getattr(x, f.name).float() for f in
                                               dataclasses.fields(x)
                                               if isinstance(getattr(x, f.name), torch.Tensor)
                                               and getattr(x, f.name).is_floating_point()})
                     if dataclasses.is_dataclass(x) and not isinstance(x, type)
                     and not hasattr(x, "cauchy_c") else x for x in args)
    bound = chip_smoke.MARG_BOUNDS[str(dtype).split(".")[-1]]
    stages = [(args, "old")] + ([((args[0], args[5]), "new")] if "no_prior" not in case else [])
    for stage_args in stages:
        depth_args, A, head, m = chip_smoke.marg_stage_inputs(*stage_args)
        assert A.dtype == dtype
        errs, absolute, readings, identical = chip_smoke.marg_compare(depth_args, A, head, m)
        assert identical and max(absolute.values()) == 0.0
        assert errs.get("marg_depth", 0.0) == 0.0 and errs[chip_smoke.MARG_STRUCTURE] == 0.0
        assert errs[chip_smoke.MARG_RTR] <= bound
        kept_bound = chip_smoke.MARG_KEPT_BOUNDS[str(dtype).split(".")[-1]]
        if dtype == torch.float32:  # the plain version is the kernel here
            assert errs[chip_smoke.MARG_KEPT] == readings["plain version"] <= kept_bound
            assert readings["torch.linalg.qr"] <= kept_bound
        else:
            assert errs[chip_smoke.MARG_KEPT] == 0.0 and not readings
        faults = chip_smoke.marg_planted_faults(depth_args, A, head, m)
        assert set(faults) == ({"marg_qr"} if depth_args is None else set(chip_smoke.MARG_FAULTS))
        for kernel, f in faults.items():
            assert set(f) == set(chip_smoke.MARG_FAULTS[kernel])
            assert all(v > bound for v in f.values()), (kernel, f)


# ------------------------------------- the kernel's blocked order (plain form)
# marg_cuda.qr_blocked_plain: marg_qr_kernel's leaves (the head by first
# non-zero column), tiles, 16-column panels with their compact WY updates,
# skipped reflections (τ = 0, T's column zero) and tree merges, in torch ops.
# TILES: the kernel's tile and leaf rows, and small ones that make the
# windows' stacks many tiles, leaves and merges.
TILES = {"kernel_tiles": {}, "small_tiles": dict(tile_rows=16, leaf_rows=96)}


def _blocked(**kw):
    return lambda A, head=0: mc.qr_blocked_plain(A, head, **kw)


def _rtr_and_kept(A, R, Rref, m, tol, singular=False):
    """RᵀR within ``tol`` of AᵀA's scale, R upper triangular, and the
    information of the rows below the first m (the prior's) within ``tol``
    of Rref's. Where the kept information is singular (``singular``) the
    residual's entry of it is left out: a kept column without information
    has a rounding-level pivot, which each order of the arithmetic draws
    otherwise, and a row taken by it splits the residual's rest with the
    last row (as the card tests leave it out)."""
    scale = float((A.abs().T @ A.abs()).max())
    assert float((R.T @ R - A.T @ A).abs().max()) <= tol * scale
    assert float(torch.tril(R, -1).abs().max()) == 0.0
    kept = lambda M: M[m:-1, m:].T @ M[m:-1, m:]
    d = kept(R) - kept(Rref)
    if singular:
        d[-1, -1] = 0.0
    assert float(d.abs().max()) <= tol * float(kept(Rref).abs().max())


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_order_matches_jax(windows, jax_priors, monkeypatch, case):
    """MARGIN_OLD with its R factor in the kernel's blocked order: JᵀJ and
    Jᵀr within 1e-8 of JAX's marginalize_old_qr, and rᵀr too where there is
    a prior (without one, JᵀJ is singular and rᵀr is not a function of JᵀJ
    and Jᵀr: ``_rtr_and_kept``)."""
    w = windows[case]
    monkeypatch.setattr(tmarg, "marg_qr", _blocked())
    tp = tmarg.marginalize_old_qr(*w["t"], w["tcfg"])
    assert bool(tp.valid)
    info_close(jax_priors[case]["old"], tp, 1e-8, with_rr="no_prior" not in case)


@pytest.mark.parametrize("case", [k for k in CASES if k.endswith("_prior") and "no_" not in k])
def test_blocked_order_second_new_matches_jax(windows, jax_priors, monkeypatch, case):
    """SECOND_NEW (a stack that is all head: leaf 0 alone, sorted by first
    column) in the kernel's blocked order: within 1e-8 of JAX's."""
    w = windows[case]
    monkeypatch.setattr(tmarg, "marg_qr", _blocked())
    tp = tmarg.marginalize_second_new_qr(w["t"][0], w["t"][5], w["tcfg"])
    assert bool(tp.valid)
    info_close(jax_priors[case]["new"], tp, 1e-8)


@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("case", list(CASES))
def test_blocked_order_matches_plain(windows, case, tiles):
    """The blocked order on MARGIN_OLD's stack and (with a prior) SECOND_NEW's
    against qr_plain's one reflection a column: RᵀR = AᵀA and the kept
    information within 1e-12 (f64; without a prior, its residual entry
    aside: ``_rtr_and_kept``)."""
    w = windows[case]
    stacks = [(tmarg.old_stack(*w["t"], w["tcfg"]), None, 15)]
    if "no_" not in case:
        stacks.append((tmarg.second_new_stack(w["t"][0], w["t"][5]), "all", 6))
    for A, head, m in stacks:
        head = A.shape[0] if head == "all" else tmarg.pose_dim(NFRAMES, 1 + ("two" in case)) + 15
        R = mc.qr_blocked_plain(A, head, **TILES[tiles])
        _rtr_and_kept(A, R, mc.qr_plain(A), m, 1e-12, singular="no_prior" in case)


@pytest.mark.parametrize("tiles", list(TILES))
def test_blocked_order_skips_empty_columns(tiles):
    """test_qr_skips_empty_columns_without_losing_rows in the blocked order
    (the two empty columns in mid-panel): their rows of R zero, RᵀR = AᵀA,
    and the information below them the dense form's with unit rows."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 8))
    A[:, [1, 5]] = 0.0
    A = torch.as_tensor(A)
    R = mc.qr_blocked_plain(A, 7, **TILES[tiles])
    assert float((R.T @ R - A.T @ A).abs().max()) <= 1e-13 * float((A.T @ A).abs().max())
    assert float(R[1].abs().max()) == 0.0 and float(R[5].abs().max()) == 0.0
    assert float(torch.tril(R, -1).abs().max()) == 0.0
    for m in (2, 6):
        ref = torch.linalg.qr(tmarg._with_unit_rows(A, m), mode="r")[1][m:, m:]
        got = R[m:, m:]
        assert float((got.T @ got - ref.T @ ref).abs().max()) <= 1e-12 * float((A.T @ A).abs().max())


@pytest.mark.parametrize("C", [173, 323, 384])
def test_blocked_order_whole_panels_that_skip(C):
    """A stack whose head is block-diagonal over columns [16, 48) (two whole
    panels where every reflection of the later tiles skips: their rows are
    zero there, and so are R's rows above), an empty column in mid-panel
    and C not a multiple of 16 (173, 323) or the widest (384): RᵀR = AᵀA,
    the empty column's row zero, the information below 15 dropped columns
    qr_plain's, within 1e-12 (f64); the same in f32 within 2e-5 of the
    f64 answer's scale (RᵀR)."""
    rng = np.random.default_rng(C)
    head, M = 60, 1400
    A = rng.standard_normal((M, C)) * np.exp(rng.uniform(-1, 1, (M, 1)))
    A[rng.random(M) < 0.3] = 0.0
    A[:, 16:48] = 0.0
    A[:20, :] = 0.0
    A[:20, 16:48] = rng.standard_normal((20, 32)) + 4 * np.eye(20, 32)
    A[:, 100] = 0.0
    A = torch.as_tensor(A)
    R = mc.qr_blocked_plain(A, head)
    assert float(R[100].abs().max()) == 0.0
    _rtr_and_kept(A, R, mc.qr_plain(A), 15, 1e-12)
    R32 = mc.qr_blocked_plain(A.float(), head).double()
    assert chip_smoke.rtr_error(A, R32) <= chip_smoke.MARG_BOUNDS["float32"]


@pytest.mark.parametrize("case", ["mono_prior", "two_cameras_no_prior"])
def test_blocked_order_zero_padded_slots_and_shuffled_rows(windows, monkeypatch, case):
    """In the blocked order: eight unused slots more leave the prior
    unchanged within 1e-12; MARGIN_OLD's stack with its rows after the head
    shuffled (other leaves, tiles and merges) has the same RᵀR and kept
    information within 1e-12."""
    w = windows[case]
    monkeypatch.setattr(tmarg, "marg_qr", _blocked())
    st, grid, *rest = w["t"]
    pst, pgrid = _padded(st, grid, 8)
    info_close(tmarg.marginalize_old_qr(st, grid, *rest, w["tcfg"]),
               tmarg.marginalize_old_qr(pst, pgrid, *rest, w["tcfg"]), 1e-12)
    A = tmarg.old_stack(*w["t"], w["tcfg"])
    head = tmarg.pose_dim(NFRAMES, 1 + ("two" in case)) + 15
    perm = torch.randperm(A.shape[0] - head, generator=torch.Generator().manual_seed(0))
    As = torch.cat([A[:head], A[head:][perm]])
    _rtr_and_kept(A, mc.qr_blocked_plain(As, head, **TILES["small_tiles"]),
                  mc.qr_blocked_plain(A, head), 15, 1e-12, singular="no_prior" in case)


@pytest.mark.parametrize("kind", ["old", "second_new"])
def test_blocked_order_matches_the_dense_form_on_empty_columns(empty_cols, monkeypatch, kind):
    """Where the dense form needs its unit rows, the blocked order gives
    the same prior within 1e-10."""
    args = empty_cols[kind]
    monkeypatch.setattr(tmarg, "marg_qr", _blocked(**TILES["small_tiles"]))
    if kind == "old":
        ref, got = dense_old_qr(*args), tmarg.marginalize_old_qr(*args)
    else:
        ref, got = dense_second_new_qr(*args), tmarg.marginalize_second_new_qr(*args)
    assert bool(ref.valid) and bool(got.valid)
    info_close(ref, got, 1e-10)


def test_marg_stamps_finds_its_anchors_in_this_source():
    """marg_stamps.py stamps this tree's csrc/marg_qr.cu (the panel design):
    every stamp's anchor is found once, and the stamped source reads the
    clock and exports its counters."""
    import pathlib

    import marg_stamps

    src = pathlib.Path(mc.__file__).parent.parent / "csrc" / "marg_qr.cu"
    text, phases, per = marg_stamps.stamped(src.read_text())
    assert per == "panel" and len(phases) == 7
    assert text.count("stamp_after(") >= 5 and 'extern "C" int marg_stamps_read' in text


# --------------------------------------- marg_depth_kernel's order (plain form)
# marg_cuda.depth_order_plain: the kernel's column table (depth_columns),
# compact rows, reflection, u = A[0] + scal Σ_{r >= 1} x_r A[r] summed only
# over the rows that carry each column, and the entries by kind, in torch
# ops. Besides the JAX windows (few features anchored at frame 0),
# chip_smoke.relo_layout's windows, with 96% of the slots anchored there.
def _depth_layout(W1, n_cams, on, dtype=F64, F=48):
    """marg_depth's arguments on a relo_layout window ("front" anchors),
    the extrinsics and td estimated (``on``) or not."""
    st, grid, cfg, _ = chip_smoke.relo_layout(torch.device("cpu"), dtype, W1, F, n_cams, "front")
    cfg = dataclasses.replace(cfg, estimate_extrinsic=on, estimate_td=on)
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res, J26, w, _ = tsolver.proj_rows(st, grid0, cfg)
    return res, J26, w, grid0, cfg, n_cams


def _depth_window(w, on=None):
    """marg_depth's arguments on a JAX comparison window (its config, or
    the extrinsics and td estimated or not by ``on``)."""
    st, grid = w["t"][:2]
    cfg = w["tcfg"] if on is None else dataclasses.replace(w["tcfg"], estimate_extrinsic=on,
                                                           estimate_td=on)
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res, J26, wts, _ = tsolver.proj_rows(st, grid0, cfg)
    return res, J26, wts, grid0, cfg, tmarg.n_cams_of(st)


DEPTH_LAYOUTS = {f"{W1}_frames_{nc}_cam{'s' if nc > 1 else ''}_{'on' if on else 'off'}":
                 (W1, nc, on) for W1 in (11, 21) for nc in (1, 2) for on in (True, False)}


@pytest.mark.parametrize("layout", list(DEPTH_LAYOUTS))
def test_depth_order_matches_depth_plain(layout):
    """The kernel's order against depth_plain in f64, within 1e-13 of each
    slot's scale (chip_smoke.depth_error), at 11 and 21 frames, one camera
    and two, the extrinsics and td estimated and not."""
    args = _depth_layout(*DEPTH_LAYOUTS[layout])
    assert chip_smoke.depth_error(args, mc.depth_order_plain(*args), mc.depth_plain(*args)) <= 1e-13


@pytest.mark.parametrize("case", ["mono_prior", "two_cameras_prior"])
@pytest.mark.parametrize("on", [True, False])
def test_depth_order_matches_depth_plain_on_the_jax_windows(windows, case, on):
    """The same on the JAX comparison's windows, the extrinsics and td
    estimated and not."""
    args = _depth_window(windows[case], on)
    assert chip_smoke.depth_error(args, mc.depth_order_plain(*args), mc.depth_plain(*args)) <= 1e-13


@pytest.mark.parametrize("case", list(CASES))
def test_depth_order_matches_jax(windows, jax_priors, monkeypatch, case):
    """MARGIN_OLD with its stage 1 in the kernel's order: within 1e-8 of
    JAX's marginalize_old_qr (without a prior, rᵀr the minimum-norm one)."""
    w = windows[case]

    def depth(res, J26, wts, grid, cfg, n_cams, out=None):
        out.copy_(mc.depth_order_plain(res, J26, wts, grid, cfg, n_cams))
        return out

    monkeypatch.setattr(tmarg, "marg_depth", depth)
    tp = tmarg.marginalize_old_qr(*w["t"], w["tcfg"])
    assert bool(tp.valid)
    info_close(jax_priors[case]["old"], tp, 1e-8, singular="no_prior" in case)


@pytest.mark.parametrize("layout", ["11_frames_2_cams_on", "11_frames_1_cam_off",
                                    "21_frames_2_cams_off"])
def test_depth_columns_describe_the_dense_rows(layout):
    """depth_columns against the dense rows of every slot (marg_cuda's
    _dense_obs_rows): an empty column (g 0) is zero in every row, a frame's
    pose column (g 2 + p) outside rows 2 p and 2 p + 1, and the others hold
    their compact column's entries; each empty column's run ends at zrun,
    the first column that is not empty."""
    args = _depth_layout(*DEPTH_LAYOUTS[layout])
    A, _ = mc._dense_obs_rows(*args)
    F, R2, C = A.shape
    q, g, zrun = mc.depth_columns(args[3].valid.shape[1], args[5], args[4].estimate_extrinsic,
                                  args[4].estimate_td)
    assert len(q) == C
    rows = np.arange(R2)
    for col in range(C):
        if g[col] == 0:
            assert float(A[:, :, col].abs().max()) == 0.0
            assert zrun[col] > col and (g[col:zrun[col]] == 0).all() and g[zrun[col]] != 0
        else:
            assert zrun[col] == col
        if g[col] >= 2:
            off = rows // 2 != g[col] - 2
            assert float(A[:, off, col].abs().max()) == 0.0
    assert (g != 0).any() and (g[6:15] == 0).all()


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_depth_plain_speed_bias_zero_and_a_nan_slot(dtype):
    """What marg_depth_kernel's stores without arithmetic rely on: on slots
    whose inputs are finite, depth_plain's rows are exactly zero in every
    empty column (depth_columns' g 0: the speed-bias columns; the
    extrinsics and td where not estimated); on a slot with a NaN depth,
    every entry of its rows after the pivot is NaN, the speed-bias columns'
    too, and its pivot row zero, and the other slots are unchanged. The
    kernel's order gives the same NaNs."""
    args = _depth_layout(11, 1, False, dtype)
    res, J26, w, grid, cfg, nc = args
    q, g, _ = mc.depth_columns(11, 1, False, False)
    F, R2, C = J26.shape[0], 20, len(q)
    ref = mc.depth_plain(*args).reshape(F, R2, C)
    assert torch.isfinite(ref).all()
    assert float(ref[:, :, g == 0].abs().max()) == 0.0
    f = int((J26[:, 1:, :, 24].abs().amax(dim=(1, 2)) > 0).nonzero()[0])
    J = J26.clone()
    J[f, 3, 1, 24] = float("nan")
    bad = (res, J, w, grid, cfg, nc)
    got = mc.depth_plain(*bad).reshape(F, R2, C)
    assert torch.isnan(got[f, 1:]).all() and float(got[f, 0].abs().max()) == 0.0
    others = torch.arange(F) != f
    assert torch.equal(got[others], ref[others])
    order = mc.depth_order_plain(*bad).reshape(F, R2, C)
    assert torch.equal(torch.isnan(order), torch.isnan(got))


def test_marg_stamps_finds_its_depth_anchors_in_this_source():
    """marg_stamps.py's depth mode stamps this tree's marg_depth_kernel (the
    flat design): every anchor is found once, and the stamped source reads
    the clock and the global timer and exports its counters."""
    import pathlib

    import marg_stamps

    src = pathlib.Path(mc.__file__).parent.parent / "csrc" / "marg_qr.cu"
    text, phases, design = marg_stamps.depth_stamped(src.read_text())
    assert design == "flat" and sum(p is not None for p in phases) == 11
    assert "%%globaltimer" in text and 'extern "C" int marg_stamps_read' in text
    assert text.count("atomicAdd(&marg_stamps[") >= 6
