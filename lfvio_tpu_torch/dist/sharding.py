"""Feature-sharded bundle adjustment on ``torch.distributed``.

Port of ``lfvio_tpu.dist.sharding``: the feature slots (landmarks and
their observation grid) are split across the ranks of a process group.
Each rank

  1. linearizes its own features (projection residuals and Jacobians),
  2. assembles its partial normal equations,
  3. all-reduces the pose block (H_pp [D, D], b_p) and, in each solve, the
     depth block's Schur terms (S, c): the only communication per LM
     iteration, besides the cost,
  4. solves the reduced D×D system redundantly and back-substitutes its
     own inverse depths.

IMU factors and the marginalization prior involve pose blocks only: every
rank evaluates them with square-root weights scaled by 1/√n, so the sum
over n ranks holds each exactly once ((J/√n)ᵀ(J/√n) summed n times is JᵀJ).
The LM loop is the single-device one (``backend/solver.py::lm_loop``):
every rank sees the same reduced costs and the same step, so the ranks
take the same branches and stay in lockstep. Run eagerly (a process group
cannot be captured), its blocks are masked (``device.cond``), so every rank
runs every iteration's collectives.

The caller creates the process group (``init_process_group``): gloo on
the CPU, NCCL where each rank has a card of its own, gloo on CUDA tensors
for several ranks on one card (NCCL refuses two ranks on one device).
Feature-axis tensors (the grid, ``state.inv_depth``, ``has_depth``) are the
rank's contiguous slice (``shard_grid``, ``shard_features``); everything
else is replicated.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..backend.solver import _schur_solve, assemble_normal_equations, lm_loop, total_cost
from ..backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState


@dataclasses.dataclass(frozen=True)
class FeatureMesh:
    """The feature axis: a process group and this process's place in it."""

    group: object  # a torch.distributed ProcessGroup; None: the default group
    rank: int
    size: int


def make_feature_mesh(group=None) -> FeatureMesh:
    """The feature axis over ``group`` (None: the default group, which the
    caller has initialized with ``torch.distributed.init_process_group``)."""
    return FeatureMesh(group, dist.get_rank(group), dist.get_world_size(group))


def _feature_slice(n: int, mesh: FeatureMesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} feature slots do not split evenly over {mesh.size} ranks")
    c = n // mesh.size
    return slice(mesh.rank * c, (mesh.rank + 1) * c)


def shard_features(x, mesh: FeatureMesh):
    """This rank's contiguous slice of a tensor's leading (feature) axis."""
    return x[_feature_slice(x.shape[0], mesh)]


def shard_grid(grid: FeatureGrid, mesh: FeatureMesh) -> FeatureGrid:
    """This rank's contiguous slice of the observation grid's features."""
    s = _feature_slice(grid.valid.shape[0], mesh)
    return FeatureGrid(
        bearing=grid.bearing[s], velocity=grid.velocity[s], td_obs=grid.td_obs[s],
        valid=grid.valid[s], anchor=grid.anchor[s], used=grid.used[s],
        cam=None if grid.cam is None else grid.cam[s],
    )


def gather_features(x, mesh: FeatureMesh):
    """The whole feature axis from every rank's slice, on every rank."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


def all_reduce_sum(mesh: FeatureMesh, *tensors):
    """The sums over the ranks of ``tensors``, reduced in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def lm_solve_sharded(mesh: FeatureMesh, state: WindowState, grid: FeatureGrid, pre,
                     sqrt_info_imu, imu_valid, prior: PriorFactor, gravity, cfg: SolverConfig,
                     max_iter_dyn=None):
    """Feature-sharded LM: the math of ``backend.solver.lm_solve``. ``grid``
    and ``state.inv_depth`` are this rank's slice; the rest is replicated.
    Returns (state with this rank's inverse depths, initial cost, final
    cost); the costs are the whole window's."""
    inv_sqrt_n = 1.0 / mesh.size ** 0.5
    si_s = sqrt_info_imu * inv_sqrt_n
    pr_s = dataclasses.replace(prior, J=prior.J * inv_sqrt_n, r0=prior.r0 * inv_sqrt_n)

    def lin_fn(s):
        H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
            s, grid, pre, si_s, imu_valid, pr_s, gravity, cfg)
        H_pp, b_p = all_reduce_sum(mesh, H_pp, b_p)
        return H_pp, H_pl, H_ll, b_p, b_l

    def solve_fn(lin, lam):
        # dx is the same on every rank. A non-finite local term reaches dx
        # through S or c, so dlam is finite wherever dx is and the ranks
        # accept or reject together.
        return _schur_solve(*lin, lam, grid.used, reduce=lambda S, c: all_reduce_sum(mesh, S, c))

    def cost_fn(s):
        return all_reduce_sum(
            mesh, total_cost(s, grid, pre, si_s, imu_valid, pr_s, gravity, cfg))[0]

    out, c0, c1 = lm_loop(state, lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn)[:3]
    return out, c0, c1
