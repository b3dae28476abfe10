"""The relocalization rows on ``chip_smoke.relo_layout``'s windows, on the CPU
in float64: the windows the card tests hold ``relo_normal_kernel`` and
``relo_cost_kernel`` on (11 and 21 frames, 256 and 384 slots, anchors 96%
at frame 0 or spread evenly, one camera or two with the extrinsics
estimated).

The port's plain versions (what the wrappers run on CPU tensors) against the
JAX package's ``linearize_relo_rows`` and the sums lm_solve_relo forms from
it (``tests/test_torch_relo_factor.py::jax_relo``), within 1e-10 of each
output's scale; ``chip_smoke``'s relo check on each window, whose planted
faults must all exceed RELO_BOUNDS; and the estimator's early capture of
the relocalization program, which does nothing on the CPU.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke
from lfvio_tpu import backend as jb

from lfvio_tpu_torch.backend import relo_cuda
from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

from test_torch_relo_factor import close, jax_relo

F64 = torch.float64
CPU = torch.device("cpu")
SHAPES = [(11, 256), (11, 384), (21, 256), (21, 384)]


def as_jax(state, grid, cfg, relo):
    """relo_layout's torch window as the JAX package's types."""
    arr = lambda x: None if x is None else jnp.asarray(x.numpy())
    js = jb.WindowState(**{f.name: arr(getattr(state, f.name)) for f in dataclasses.fields(state)})
    jg = jb.FeatureGrid(
        bearing=arr(grid.bearing), velocity=arr(grid.velocity), td_obs=arr(grid.td_obs),
        valid=arr(grid.valid), anchor=arr(grid.anchor.to(torch.int32)), used=arr(grid.used),
        cam=None if grid.cam is None else arr(grid.cam.to(torch.int32)))
    jc = jb.SolverConfig(n_cams=cfg.n_cams, estimate_extrinsic=cfg.estimate_extrinsic)
    return js, jg, jc, tuple(x.numpy() for x in relo)


@pytest.mark.parametrize("W1,n_slots,layout,n_cams",
                         [(11, 256, "front", 1), (21, 384, "front", 2), (11, 384, "spread", 2),
                          (21, 256, "spread", 1)])
def test_relo_layout_plain_matches_jax(W1, n_slots, layout, n_cams):
    """``relo_normal`` and ``relo_cost`` on CPU tensors (their plain
    versions) on a relo_layout window, adding into a random base system:
    equal to JAX's augmented sums and relo cost from the same inputs."""
    args = chip_smoke.relo_layout(CPU, F64, W1, n_slots, n_cams, layout)
    state, grid, cfg, relo = args
    F = n_slots
    D = pose_dim(W1, n_cams_of(state))
    rng = np.random.default_rng(1)
    base = (rng.standard_normal((D, D)), rng.standard_normal((D, F)), rng.random(F) + 1.0,
            rng.standard_normal(D), rng.standard_normal(F))
    js, jg, jc, jrelo = as_jax(*args)
    rows, system = jax.jit(lambda *a: jax_relo(*a, jc))(js, jg, *map(jnp.asarray, jrelo),
                                                         tuple(map(jnp.asarray, base)))
    # Copies: relo_normal adds in place, and jnp.asarray may share a 64-byte
    # aligned numpy buffer with the JAX computation dispatched above.
    t = lambda x: torch.tensor(x, dtype=F64)
    pad = torch.nn.functional.pad
    sums = (pad(t(base[0]), (0, 6, 0, 6)), pad(t(base[1]), (0, 0, 0, 6)), t(base[2]),
            pad(t(base[3]), (0, 6)), t(base[4]))
    out = relo_cuda.relo_normal(*sums, state, grid, *relo, cfg)
    for ref, ours in zip(system, out):
        close(ref, ours)
    close(rows[4], 0.5 * relo_cuda.relo_cost(state, grid, *relo, cfg).sum())


@pytest.mark.parametrize("n_cams", [1, 2])
@pytest.mark.parametrize("layout", ["front", "spread"])
@pytest.mark.parametrize("W1,n_slots", SHAPES)
def test_relo_layout_check_rejects_planted_faults(W1, n_slots, layout, n_cams):
    """chip_smoke's relo check on each window the card tests use, run on
    the CPU: the plain version passes it, a repeat is identical, the window
    has the layout it is named for, and every planted fault (on two
    cameras also the loop side's block in the anchor camera's columns)
    exceeds RELO_BOUNDS on the outputs that must reject it."""
    args = chip_smoke.relo_layout(CPU, F64, W1, n_slots, n_cams, layout)
    state, grid, cfg, relo = args
    kept = relo[3] & grid.used
    front = float((grid.anchor[kept] == 0).float().mean())
    assert (front > 0.9) if layout == "front" else (front < 0.2)
    assert cfg.estimate_extrinsic == (n_cams == 2)
    bound = chip_smoke.RELO_BOUNDS["float64"]
    errs, _, identical = chip_smoke.relo_compare(args)
    assert identical and max(errs.values()) <= bound, errs
    faults = chip_smoke.relo_planted_faults(args)
    assert len(faults) == (3 if n_cams == 2 else 2)
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.RELO_FAULT_OUTPUTS[fault]), (fault, fe)


def test_relo_program_not_captured_early_on_the_cpu():
    """``Estimator._capture_relo`` (on the card: the relocalization graph
    captured at the first solve) makes no program on the CPU, so the CPU
    tests pay no extra eager relo solve."""
    from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig

    est = Estimator(EstimatorConfig(n_feature_slots=16, solver_dtype=F64, device="cpu"))
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    est._capture_relo(packed, est._empty_prior())
    assert not est._programs
