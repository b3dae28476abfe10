"""The port's feature-sharded frame step (``lfvio_tpu_torch.dist``) on gloo
process groups of 2 and 4 CPU processes.

Each rank is a process of its own (``tests/_torch_dist_child.py``) that
joins its group through a file and gets a 60 s timeout; the parent waits
for each process with a timeout too. All runs start together in one module
fixture. Bounds, float64 on the CPU:

* against the port's single-device chain (preintegrate → triangulate →
  ``lm_solve`` → gauge → ``marginalize_old_qr`` / ``marginalize_second_new_qr``,
  themselves held against JAX in tests/test_torch_backend.py): states,
  inverse depths, costs and the prior's JᵀJ and Jᵀr within 1e-9 of their
  scale; every rank's outputs identical;
* against the JAX package's single-device pieces run as one chain: 1e-7;
* on a grid that mixes features anchored at frame 0 with features that are
  not (where the single-device QR drops information), against the
  eigendecomposition marginalization: 1e-8.
"""

import dataclasses
import os
import subprocess
import sys

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
from lfvio_tpu.backend import triangulate as jtri

from lfvio_tpu_torch.backend import marginalize_old
from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
from tests import _torch_dist_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"2-old": (2, "old"), "4-old": (4, "old"), "2-new": (2, "new"),
        "4-old-mixed": (4, "old-mixed")}
STATE_KEYS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


def close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's per-rank outputs, {run: [rank outputs]}."""
    root = tmp_path_factory.mktemp("dist")
    procs = {}
    for name, (world, case) in RUNS.items():
        d = root / name
        d.mkdir()
        procs[name] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_dist_child.py"), str(r),
             str(world), str(d / "init"), str(d / f"rank{r}.npz"), case],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    out = {}
    try:
        for name, ps in procs.items():
            for p in ps:
                log, _ = p.communicate(timeout=120)
                assert p.returncode == 0, log[-3000:]
            out[name] = [dict(np.load(root / name / f"rank{r}.npz")) for r in range(len(ps))]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


@pytest.mark.parametrize("name", ["2-old", "4-old", "2-new"])
def test_sharded_step_matches_single_device(runs, name):
    ranks = runs[name]
    for other in ranks[1:]:  # the replicated outputs agree bit for bit
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k])
    out, prior, c0, c1 = child.single_device_step(child.problem(), marg_old=RUNS[name][1] == "old")
    got = ranks[0]
    for k in STATE_KEYS:
        close(getattr(out, k).numpy(), got[k], 1e-9)
    close(c0.numpy(), got["c0"], 1e-9)
    close(c1.numpy(), got["c1"], 1e-9)
    close((prior.J.T @ prior.J).numpy(), got["H"], 1e-9)
    close((prior.J.T @ prior.r0).numpy(), got["b"], 1e-9)
    close(prior.x0_p.numpy(), got["x0_p"], 1e-9)
    assert bool(got["valid"]) and float(got["c1"]) < float(got["c0"])


def test_sharded_tsqr_keeps_mixed_anchor_information(runs):
    """4 ranks on a grid where feature 1 is anchored at frame 0 beside
    features that are not: the TSQR prior equals the eigendecomposition
    prior (marginalize_old) at the solved state."""
    pb = child.problem(mixed=True)
    out, _, _, _ = child.single_device_step(pb)
    state, grid, prior, gravity, cfg = (pb[k] for k in ("state", "grid", "prior", "gravity", "cfg"))
    dts, accs, gyrs, a0, g0 = pb["imu"]
    pre = preintegrate(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, pb["imu_valid"])
    ref = marginalize_old(out, grid, pre, si, ok, prior, gravity, cfg)
    got = runs["4-old-mixed"][0]
    close((ref.J.T @ ref.J).numpy(), got["H"], 1e-8)
    close((ref.J.T @ ref.r0).numpy(), got["b"], 1e-8)


def test_sharded_step_matches_jax_chain(runs):
    """The 2-rank MARGIN_OLD step against the JAX package's single-device
    pieces (preintegrate_parallel, whiten, triangulate, lm_solve, gauge,
    marginalize_old_qr) on the same inputs, run as one jitted chain."""
    pb = child.problem()
    n = lambda x: np.asarray(x.numpy())
    s, g, pr = pb["state"], pb["grid"], pb["prior"]
    state = jb.WindowState(**{k: jnp.asarray(n(getattr(s, k))) for k in STATE_KEYS})
    grid = jb.FeatureGrid(bearing=jnp.asarray(n(g.bearing)), velocity=jnp.asarray(n(g.velocity)),
                          td_obs=jnp.asarray(n(g.td_obs)), valid=jnp.asarray(n(g.valid)),
                          anchor=jnp.asarray(n(g.anchor)), used=jnp.asarray(n(g.used)))
    prior = jb.PriorFactor(**{f: jnp.asarray(n(getattr(pr, f))) for f in (
        "J", "r0", "x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg", "x0_tic", "x0_qic", "x0_td",
        "valid")})
    noise = jimu.ImuNoise(*(getattr(pb["noise"], f) for f in ("acc_n", "gyr_n", "acc_w", "gyr_w")))
    cfg = jb.SolverConfig(max_iterations=pb["cfg"].max_iterations)
    gravity = jnp.asarray(n(pb["gravity"]))
    imu = [jnp.asarray(n(x)) for x in pb["imu"]]

    @jax.jit
    def chain(state, grid, prior, imu, imu_valid, has_depth):
        pre = jax.vmap(lambda d, ac, gy, a, w, ba, bg: jimu.preintegrate_parallel(
            d, ac, gy, a, w, ba, bg, noise))(*imu, state.ba[:-1], state.bg[:-1])
        si, ok = jimu.whiten_covariance(pre.covariance, imu_valid)
        state = dataclasses.replace(state, inv_depth=jtri.triangulate_grid(state, grid, has_depth))
        out, c0, c1, _ = jb.lm_solve(state, grid, pre, si, ok, prior, gravity, cfg)
        out = jgauge.yaw_gauge_fix(out, state.p[0], state.q[0])
        return out, jmarg.marginalize_old_qr(out, grid, pre, si, ok, prior, gravity, cfg), c0, c1

    out, new_prior, c0, c1 = chain(state, grid, prior, imu, jnp.asarray(n(pb["imu_valid"])),
                                   jnp.asarray(n(pb["has_depth"])))
    got = runs["2-old"][0]
    for k in STATE_KEYS:
        close(getattr(out, k), got[k], 1e-7)
    close(c1, got["c1"], 1e-7)
    J, r0 = np.asarray(new_prior.J), np.asarray(new_prior.r0)
    close(J.T @ J, got["H"], 1e-7)
    close(J.T @ r0, got["b"], 1e-7)
