"""Scaling rows of the port's sharded solves, over ``torch.distributed`` ranks.

    python -m lfvio_tpu_torch.dist.scaling_bench [n_features] [--device D]
        [--shapes 1,2,4] [--reps 5]
    python -m lfvio_tpu_torch.dist.scaling_bench --kf [n_features] [--device D]
        [--shapes 1x1,1x2,2x1,2x2,4x1] [--reps 3]

The torch counterpart of the repository root's ``scaling_bench.py`` (the JAX
package's, on a virtual CPU mesh), with its rows and its JSON lines:

* feature rows: ``vio_frame_step_sharded`` (MARGIN_OLD) on
  ``make_window_problem(n_features, float32, max_iterations=8)`` with td,
  extrinsics and a prior, on 1, 2 and 4 ranks: ms per step over ``--reps``
  steps after a first call, the speed-up and the efficiency, then
  ``{"metric": "sharded_frame_step_ms", ...}``;
* keyframe rows (``--kf``): ``segmented_trajectory_solve`` on
  ``make_segmented_problem(S, 5, Fseg, float32, noise=0)``, 4 rounds, on
  kf × f grids of ranks (Fseg = n_features split over the segments, as the
  JAX script does): ms per round over ``--reps`` solves after a first
  call, then ``{"metric": "kf_axis_round_ms", ...}``.

Each rank is a spawned process (gloo through a ``file://`` rendezvous, 60 s
collective timeouts) with its tensors on ``--device`` (default: the CUDA
card; every rank on that one card, gloo carrying CUDA tensors). On one card
all ranks share the card and the host's cores, so these rows measure what
sharding costs, not a speed-up: the caveat SCALING.md §2 gives the JAX
package's virtual CPU mesh. A row's time is its slowest rank's.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..imu import ImuNoise

TIMEOUT = datetime.timedelta(seconds=60)
IMU_NOISE = ImuNoise(0.02, 0.01, 0.04, 0.001)  # the JAX script's
STATE_KEYS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


def spawn_ranks(target, world, args, timeout=600.0):
    """Run ``target(rank, world, init_file, out_path, *args)`` in ``world``
    spawned processes joined through one rendezvous file; each rank writes
    its results to ``out_path`` (.npz). Returns the ranks' results as dicts.
    Raises if a rank fails or is still running after ``timeout`` s (it is
    killed then)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{r}.npz") for r in range(world)]
        procs = [ctx.Process(target=target,
                             args=(r, world, os.path.join(tmp, "init"), outs[r], *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(timeout=max(0.0, t_end - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(c != 0 for c in codes):
            raise RuntimeError(f"{target.__name__} on {world} ranks: exit codes {codes}"
                               + (f"; ranks {hung} killed after {timeout:.0f} s" if hung else ""))
        return [dict(np.load(o)) for o in outs]


def _join(rank, world, init_file, device):
    """This process's place in the group, and its device and synchronize."""
    from ..device import resolve_device

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    return dev, sync


def _timed(fn, sync):
    """(result, seconds) of ``fn`` with the ranks started together and the
    device drained at the end."""
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _frame_rank(rank, world, init_file, out_path, n_feat, reps, device):
    """One rank of a feature row: the sharded frame step, a first call and
    ``reps`` timed steps."""
    from . import make_feature_mesh, shard_features, shard_grid, vio_frame_step_sharded
    from ..runtime.profiling import make_window_problem

    dev, sync = _join(rank, world, init_file, device)
    try:
        mesh = make_feature_mesh()
        pb = make_window_problem(n_feat, torch.float32, max_iterations=8, estimate_td=True,
                                 estimate_extrinsic=True, with_prior=True, device=dev)
        state = pb["state"]
        imu = [torch.as_tensor(pb[k], dtype=torch.float32, device=dev)
               for k in ("dts", "accs", "gyrs", "a0", "g0")]
        iv = torch.as_tensor(pb["imu_valid"], device=dev)
        s_state = state.replace(inv_depth=shard_features(state.inv_depth, mesh))
        s_grid = shard_grid(pb["grid"], mesh)
        has_depth = shard_features(torch.zeros(n_feat, dtype=torch.bool, device=dev), mesh)

        def step():
            return vio_frame_step_sharded(mesh, s_state, s_grid, *imu, iv, pb["prior"], has_depth,
                                          state.p[0], state.q[0], pb["noise"], pb["cfg"],
                                          marg_old=True)

        _, first_s = _timed(step, sync)
        step_s = [_timed(step, sync)[1] for _ in range(reps)]
        np.savez(out_path, first_s=first_s, step_s=np.asarray(step_s))
    finally:
        dist.destroy_process_group()


def _kf_rank(rank, world, init_file, out_path, S, n_f, wseg, fseg, reps, n_outer, device,
             dtype_name, noise, cost_tol):
    """One rank of a keyframe row: the segmented solve, a first call and
    ``reps`` timed calls; rank 0 also writes the last call's outputs and the
    trajectory's truth and initial positions."""
    from ..backend.state import SolverConfig
    from .kf_axis import make_kf_mesh, segmented_trajectory_solve
    from .synthetic_traj import G_NORM, make_segmented_problem

    dev, sync = _join(rank, world, init_file, device)
    try:
        mesh = make_kf_mesh(S, n_f, timeout=TIMEOUT)
        pb = make_segmented_problem(S, wseg, fseg, getattr(torch, dtype_name), noise=noise,
                                    device=dev)
        cfg = SolverConfig(max_iterations=6, estimate_td=False, estimate_extrinsic=False,
                           cost_tol=cost_tol)

        def solve():
            return segmented_trajectory_solve(
                mesh, pb["states"], pb["grids"], pb["dts"], pb["accs"], pb["gyrs"], pb["a0"],
                pb["g0"], pb["imu_valid"], pb["priors"], IMU_NOISE, cfg, g_norm=G_NORM,
                n_outer=n_outer)

        out, first_s = _timed(solve, sync)
        solve_s = []
        for _ in range(reps):
            out, t = _timed(solve, sync)
            solve_s.append(t)
        res = dict(first_s=first_s, solve_s=np.asarray(solve_s))
        if rank == 0:
            states, gap, costs, hist = out
            n = lambda x: x.detach().double().cpu().numpy()
            res.update({k: n(getattr(states, k)) for k in STATE_KEYS})
            res.update(gap=n(gap), costs=n(costs), hist=n(hist), p_truth=pb["truth"][1],
                       p_init=pb["p_init"])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def frame_rows(n_feat=256, counts=(1, 2, 4), reps=5, device=None):
    """{ranks: seconds per sharded frame step (the slowest rank's mean)}."""
    out = {}
    for n in counts:
        ranks = spawn_ranks(_frame_rank, n, (n_feat, reps, device))
        out[n] = max(float(np.mean(r["step_s"])) for r in ranks)
    return out


def kf_rows(shapes, fseg, wseg=5, reps=3, n_outer=4, device=None, dtype=torch.float32,
            noise=0.0, cost_tol=1e-6):
    """Each (S, n_f) grid's segmented solve (6 LM iterations a round) on
    ``make_segmented_problem(S, wseg, fseg(S, n_f), dtype, noise)``.
    Returns {(S, n_f): dict(round_s: seconds per round of each rank,
    [world]; first_s: each rank's first call, [world]; and rank 0's outputs:
    the states' fields p, q, ... [S, ...], gap, costs, hist, p_truth,
    p_init)}; with reps = 0, round_s is empty and the outputs are the first
    call's."""
    out = {}
    for S, n_f in shapes:
        ranks = spawn_ranks(_kf_rank, S * n_f, (S, n_f, wseg, fseg(S, n_f), reps, n_outer,
                                                 device, str(dtype).split(".")[-1], noise,
                                                 cost_tol))
        res = dict(ranks[0])
        res["first_s"] = np.asarray([float(r["first_s"]) for r in ranks])
        res["round_s"] = np.asarray([np.mean(r["solve_s"]) / n_outer for r in ranks
                                     if len(r["solve_s"])])
        out[(S, n_f)] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_features", nargs="?", type=int, help="256 (feature rows), 64 (--kf)")
    ap.add_argument("--kf", action="store_true", help="keyframe-axis rows")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--shapes", default=None,
                    help="rank counts (1,2,4) or kf x f grids (1x1,1x2,2x1,2x2,4x1)")
    ap.add_argument("--reps", type=int, default=None, help="timed calls (5; --kf: 3)")
    a = ap.parse_args(argv)
    if a.reps is not None and a.reps < 1:
        ap.error("--reps must be at least 1")
    if a.kf:
        n_feat = a.n_features or 64
        shapes = [tuple(int(x) for x in s.split("x"))
                  for s in (a.shapes or "1x1,1x2,2x1,2x2,4x1").split(",")]
        fseg = lambda S, n_f: max(n_feat // S // n_f * n_f, n_f)
        rows = kf_rows(shapes, fseg, reps=3 if a.reps is None else a.reps, device=a.device)
        for (S, n_f), r in rows.items():
            print(f"mesh {S}x{n_f} (kf x f), Fseg={fseg(S, n_f)}: "
                  f"{r['round_s'].max() * 1e3:8.1f} ms/round", file=sys.stderr, flush=True)
        print(json.dumps({
            "metric": "kf_axis_round_ms",
            "segments_x_fshards": {f"{S}x{n_f}": round(float(r["round_s"].max()) * 1e3, 1)
                                   for (S, n_f), r in rows.items()},
        }))
        return
    n_feat = a.n_features or 256
    counts = [int(x) for x in (a.shapes or "1,2,4").split(",")]
    rows = frame_rows(n_feat, counts, 5 if a.reps is None else a.reps, a.device)
    for n, dt in rows.items():
        speedup = rows[counts[0]] / dt
        print(f"ranks={n}: {dt * 1e3:8.1f} ms/step  speedup={speedup:5.2f}x  "
              f"strong-scaling efficiency={100 * speedup * counts[0] / n:5.1f}%",
              file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "sharded_frame_step_ms",
        "n_features": n_feat,
        "per_device_count": {str(k): round(v * 1e3, 1) for k, v in rows.items()},
    }))


if __name__ == "__main__":
    main()
