"""The port's IMU factor (``factors.imu_jacobian``, the plain versions in
``backend/imu_cuda.py`` that the CPU runs, and the solver functions over
them) against the JAX package's forward-mode linearization, on the CPU in
float64.

Each case is one of tests/test_torch_proj_factor.py's four windows (window
10 and 20, two cameras, both estimate flags off) with the biases moved off
the preintegration's linearization point after the preintegration (ba by
0.05, bg by 0.01 standard deviations) and interval 1 invalid. The same numpy
inputs go through JAX's jitted ``linearize_imu_rows`` /
``assemble_normal_equations`` / ``total_cost`` and the port's. The bound is
1e-10 of each output's scale (its largest magnitude, at least 1): the
analytic Jacobian and forward-mode autodiff agree to a few roundings, and
the sums differ only in their order. ``imu_jacobian`` is also held against
``torch.func.jacfwd`` of ``imu.imu_residual`` within 1e-12 of its scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

torch.set_num_threads(1)

from lfvio_tpu.backend import solver as jsolver

from lfvio_tpu_torch.backend import factors as tfactors
from lfvio_tpu_torch.backend import imu_cuda
from lfvio_tpu_torch.backend import marginalize as tmarg
from lfvio_tpu_torch.backend import solver as tsolver
from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim
from lfvio_tpu_torch.geom import quat_mul, so3_exp
from lfvio_tpu_torch.imu import Preintegration, imu_residual
from test_torch_proj_factor import CASES, close
from test_torch_proj_factor import case as proj_case

F64 = torch.float64
INVALID = 1  # the interval each case marks invalid

_cache = {}


def case(name):
    """(JAX arguments, port arguments) of assemble_normal_equations: the
    projection case ``name`` with its biases moved off the preintegration's
    linearization point and interval INVALID invalid."""
    if name in _cache:
        return _cache[name]
    (st, grid, pre, si, iv, prior, g, cfg), (tst, tgrid, tpre, tsi, tiv, tprior, tg, tcfg) = \
        proj_case(name)
    rng = np.random.default_rng(17)
    ba = np.asarray(st.ba) + 0.05 * rng.standard_normal(st.ba.shape)
    bg = np.asarray(st.bg) + 0.01 * rng.standard_normal(st.bg.shape)
    valid = np.asarray(iv).copy()
    valid[INVALID] = False
    st = dataclasses.replace(st, ba=jnp.asarray(ba), bg=jnp.asarray(bg))
    tst = dataclasses.replace(tst, ba=torch.as_tensor(ba), bg=torch.as_tensor(bg))
    out = ((st, grid, pre, si, jnp.asarray(valid), prior, g, cfg),
           (tst, tgrid, tpre, tsi, torch.as_tensor(valid), tprior, tg, tcfg))
    _cache[name] = out
    return out


def imu_args(name):
    """The port's (state, pre, sqrt_info, imu_valid, gravity) of the case."""
    st, _, pre, si, iv, _, g, _ = case(name)[1]
    return st, pre, si, iv, g


@pytest.mark.parametrize("name", CASES)
def test_cases_move_the_biases_off_the_linearization_point(name):
    """Every case's biases differ from the preintegration's linearization
    point (the bg offset is what the normalization's derivative sees), and
    exactly interval INVALID is invalid."""
    st, pre, _, iv, _ = imu_args(name)
    assert float((st.ba[:-1] - pre.linearized_ba).abs().min()) > 1e-5
    assert float((st.bg[:-1] - pre.linearized_bg).abs().min()) > 1e-5
    assert (~iv).nonzero().reshape(-1).tolist() == [INVALID]


@pytest.mark.parametrize("name", CASES)
def test_linearize_imu_rows(name):
    (st, _, pre, si, iv, _, g, _), (tst, _, tpre, tsi, tiv, _, tg, _) = case(name)
    ja = jax.jit(jsolver.linearize_imu_rows)(st, pre, si, iv, g)
    ta = tsolver.linearize_imu_rows(tst, tpre, tsi, tiv, tg)
    for x, y in zip(ja, ta):
        close(x, y)
    rows = slice(15 * INVALID, 15 * INVALID + 15)
    assert bool((ta[0][INVALID] == 0).all()) and bool((ta[1][rows] == 0).all())


@pytest.mark.parametrize("name", CASES)
def test_assemble_normal_equations(name):
    j, tt_ = case(name)
    ja = jax.jit(jsolver.assemble_normal_equations, static_argnums=7)(*j)
    ta = tsolver.assemble_normal_equations(*tt_)
    for x, y in zip(ja, ta):
        close(x, y)


@pytest.mark.parametrize("name", CASES)
def test_total_cost(name):
    j, tt_ = case(name)
    close(jax.jit(jsolver.total_cost, static_argnums=7)(*j), tsolver.total_cost(*tt_))


@pytest.mark.parametrize("name", CASES)
def test_imu_jacobian_against_jacfwd(name):
    """The analytic rows against forward-mode autodiff of the whitened
    ``imu_residual`` over the 30 tangents, interval by interval."""
    st, pre, si, _, g = imu_args(name)

    def local(d, dp, dq, dv, jac, sum_dt, lba, lbg, si, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1,
              bg1):
        r = si @ imu_residual(
            Preintegration(dp, dq, dv, jac, None, sum_dt, lba, lbg),
            p0 + d[0:3], quat_mul(q0, so3_exp(d[3:6])), v0 + d[6:9], ba0 + d[9:12],
            bg0 + d[12:15], p1 + d[15:18], quat_mul(q1, so3_exp(d[18:21])), v1 + d[21:24],
            ba1 + d[24:27], bg1 + d[27:30], g)
        return r, r

    ends = (st.p[:-1], st.q[:-1], st.v[:-1], st.ba[:-1], st.bg[:-1],
            st.p[1:], st.q[1:], st.v[1:], st.ba[1:], st.bg[1:])
    args = (pre.delta_p, pre.delta_q, pre.delta_v, pre.jacobian, pre.sum_dt,
            pre.linearized_ba, pre.linearized_bg, si, *ends)
    J_ad, r_ad = vmap(jacfwd(local, has_aux=True), in_dims=(None,) + (0,) * len(args))(
        torch.zeros(30, dtype=F64), *args)
    r, J = tfactors.imu_jacobian(pre, si, *ends, g)
    close(r_ad.numpy(), r, 1e-12)
    close(J_ad.numpy(), J, 1e-12)


@pytest.mark.parametrize("name", CASES)
def test_wrappers_run_their_plain_versions_on_the_cpu(name):
    """On CPU tensors ``imu_rows`` / ``imu_cost`` / ``imu_normal`` are their
    plain versions bit for bit; ``imu_normal_plain`` adds the products of
    ``imu_rows_plain``'s dense rows into H_pp and b_p in place, and its cost
    terms equal ``imu_cost_plain``'s."""
    args = imu_args(name)
    st = args[0]
    rows = imu_cuda.imu_rows_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(imu_cuda.imu_rows(*args), rows))
    cost = imu_cuda.imu_cost_plain(*args)
    assert torch.equal(imu_cuda.imu_cost(*args), cost)
    D = pose_dim(st.p.shape[0], n_cams_of(st))
    H0 = torch.as_tensor(np.random.default_rng(3).standard_normal((D, D)))
    b0 = torch.as_tensor(np.random.default_rng(4).standard_normal(D))
    H, b = H0.clone(), b0.clone()
    out = imu_cuda.imu_normal(H, b, *args)
    assert out[0] is H and out[1] is b
    Jimu = imu_cuda.dense_rows(rows[1], D)
    assert torch.equal(H, H0 + Jimu.T @ Jimu)
    assert torch.equal(b, b0 + Jimu.T @ rows[0].reshape(-1))
    close(cost.numpy(), out[2], 1e-12)
    assert float(cost[INVALID]) == 0.0


FORWARD_AD_OPS = ("aten::_make_dual", "aten::_fw_primal", "aten::_unpack_dual")


def test_solve_and_marginalization_run_no_forward_ad():
    """``lm_solve`` and ``marginalize_old_qr`` under torch.profiler launch no
    forward-mode autodiff op: every Jacobian on those paths is analytic."""
    st, grid, pre, si, iv, prior, g, cfg = case("backend")[1]
    cfg = dataclasses.replace(cfg, max_iterations=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = tsolver.lm_solve(st, grid, pre, si, iv, prior, g, cfg)[0]
        tmarg.marginalize_old_qr(out, grid, pre, si, iv, prior, g, cfg)
    names = {e.name for e in prof.events()}
    assert "marg_old::qr" in names and "aten::linalg_cholesky_ex" in names
    assert not names & set(FORWARD_AD_OPS), sorted(names & set(FORWARD_AD_OPS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("W1", [2, 11, 21, 41])
def test_imu_check_rejects_planted_faults(dtype, W1):
    """chip_smoke's check of the IMU kernels, run on the CPU (where the
    wrappers are their plain versions) at window 1, 10, 20 and 40: the plain
    version passes it, each cost output agrees with Σ r_w² of the rows, and
    each planted fault (a zero cost, the least-cost interval dropped, r_q's
    sign flipped) exceeds IMU_BOUNDS on the outputs that must reject it.
    Interval 1 is invalid, except at W1 = 2, whose one interval is valid."""
    import chip_smoke

    args = chip_smoke.imu_window(torch.device("cpu"), dtype, W1,
                                 invalid=1 if W1 > 2 else None)
    bound = chip_smoke.IMU_BOUNDS[str(dtype).split(".")[-1]]
    errs, _, identical = chip_smoke.imu_compare(args)
    assert identical
    assert max(errs.values()) <= bound, errs
    faults = chip_smoke.imu_planted_faults(args)
    assert set(faults) == set(chip_smoke.IMU_FAULT_OUTPUTS)
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.IMU_FAULT_OUTPUTS[fault]), (fault, fe)
