"""The LK kernel (lfvio_tpu_torch/csrc/lk_pyramid.cu) on a CUDA card: the fused
launch per frame, one level step as a one-pass launch of the same kernel, and
its Pallas-geometry mode (klt.pyramidal_lk_pallas).
The eigensolver kernel (lfvio_tpu_torch/csrc/sym_eig.cu) against
torch.linalg.eigh, and the estimator's programs as CUDA graphs against the
same functions run eagerly. The projection factor's kernels
(lfvio_tpu_torch/csrc/proj_factor.cu: rows, normal equations, cost) and the
IMU factor's (lfvio_tpu_torch/csrc/imu_factor.cu: rows, normal equations,
cost) and the relocalization rows' (csrc/proj_factor.cu: relo_normal,
relo_cost) against their plain versions in backend/proj_cuda.py,
backend/imu_cuda.py and backend/relo_cuda.py.

Every test here needs the card: the kernel has no CPU mode, so they skip
without one. This file imports neither JAX nor the JAX package, so it also
runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from lfvio_tpu_torch.frontend import gaussian_pyramid, klt, klt_cuda

pytestmark = pytest.mark.cuda

# Besides the loose bounds (ok on >= 99%, 0.05 px), a tight one: the
# largest kernel-vs-plain error seen on an H100 is 1.2e-4 px, so 2e-3 px
# still passes float32 sums in another order but catches a kernel that
# mishandles a few taps, such as clamping an out-of-patch tap instead of
# reading 0.
TIGHT_PX = 2e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _shift_case(dev, H=480, W=640, N=96, dx=2.7, dy=-1.9, seed=0, n_border=0, waves=False,
                n_levels=3):
    """A smoothed blocky texture, its bilinear shift by (dx, dy), the
    pyramids of both (n_levels above the image) and N points away from the
    border (4 invalid).
    ``n_border`` extra points lie within 30 px of the borders and corners;
    ``waves`` puts the texture on long waves that LK follows at coarse levels."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.random((H // 8, W // 8)), np.ones((8, 8)))
    for ax in (0, 1):  # 5-tap box blur
        img = sum(np.roll(img, s, axis=ax) for s in range(-2, 3)) / 5.0
    if waves:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
        wave = sum(np.sin(2 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / lam + ph)
                   for lam, th, ph in zip(rng.uniform(160, 400, 12), rng.uniform(0, np.pi, 12),
                                          rng.uniform(0, 2 * np.pi, 12)))
        img = 0.15 * img + 0.85 * (wave - wave.min()) / (wave.max() - wave.min())
    img0 = torch.as_tensor(img * 255.0, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    grid = torch.stack([(xx - dx) / (W - 1) * 2 - 1, (yy - dy) / (H - 1) * 2 - 1], -1)
    img1 = torch.nn.functional.grid_sample(
        img0[None, None], grid[None].float(), mode="bilinear", align_corners=True,
        padding_mode="border")[0, 0]
    pts = np.stack([rng.uniform(50, W - 50, N), rng.uniform(50, H - 50, N)], -1)
    if n_border:
        near = lambda size: np.where(rng.random(n_border) < 0.5, rng.uniform(0, 30, n_border),
                                     size - 1 - rng.uniform(0, 30, n_border))
        side = np.arange(n_border) % 3  # 0: corner, 1: top/bottom, 2: left/right
        bx = np.where(side == 1, rng.uniform(0, W - 1, n_border), near(W))
        by = np.where(side == 2, rng.uniform(0, H - 1, n_border), near(H))
        pts = np.concatenate([pts, np.stack([bx, by], -1)])
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    valid[:4] = False
    return (gaussian_pyramid(img0, n_levels), gaussian_pyramid(img1, n_levels), pts, valid,
            (dx, dy))


@pytest.mark.parametrize("win,iters", [(klt.WIN, klt.N_ITERS), (15, klt.REFINE_ITERS)])
def test_level_step_matches_plain(dev, win, iters):
    """One level step at both windows: ok on >= 99% of features alike and
    positions within 0.05 px (float32 sums in another order); tight: ok
    identical and positions within TIGHT_PX."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev)
    g0 = torch.zeros_like(pts)
    before = klt_cuda.lk_level.launches
    kg, kok = klt_cuda.lk_level(pyr0[0], pyr1[0], pts, g0, valid, win, iters)
    torch.cuda.synchronize()
    assert klt_cuda.lk_level.launches == before + 1
    pg, pok = klt.track_level(pyr0[0], pyr1[0], pts, g0, valid, win, iters)
    assert (kok == pok).float().mean().item() >= 0.99
    assert not kok[:4].any()
    both = kok & pok
    err = (kg[both] - pg[both]).abs().max().item()
    assert err < 0.05
    assert torch.equal(kok, pok)
    assert err < TIGHT_PX


@pytest.mark.parametrize("size", [(480, 640), (384, 512)])
def test_fused_pyramid_matches_plain_and_truth(dev, size):
    """The fused launch (all levels and the refine pass): one launch,
    agreement with the plain version under the loose and the tight bound,
    the known shift recovered (median error < 0.35 px), and the iteration
    counts it reports within their limits."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, *size)
    before = klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches
    kp, kok, iters = klt_cuda.lk_pyramid(pyr0, pyr1, pts, valid, 3, refine_win=15,
                                         return_iters=True)
    torch.cuda.synchronize()
    assert (klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches) == (before[0] + 1, before[1])
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert (kok == pok).float().mean().item() >= 0.99
    both = kok & pok
    assert both.sum().item() >= len(pts) - 10
    err = (kp[both] - pp[both]).abs().max().item()
    assert err < 0.05
    assert err < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    assert iters.shape == (len(pts), 5) and (iters[:4] == -1).all()
    limit = torch.tensor([klt.N_ITERS] * 4 + [klt.REFINE_ITERS], device=dev)
    assert (iters[kok] >= 0).all() and (iters <= limit).all() and (iters[kok].sum(1) > 0).all()


@pytest.mark.parametrize("size", [(960, 1280), (384, 512)])
def test_fused_border_and_corner_points(dev, size):
    """Points within 30 px of the borders and corners, where the edge
    replication (an index clamp in the kernel) and the patch clamps work:
    ok identical to the plain version's, positions within TIGHT_PX."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, *size, N=32, n_border=96, dx=3.3, dy=-2.6)
    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, pok)
    assert 8 <= kok[32:].sum().item() < 96  # some border points survive, some leave
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX


def test_fused_lost_tracks(dev):
    """A shift of 5.6 px at level 3 leaves the search patch for a part of
    the features: ok identical to the plain version's, a real mix of kept
    and lost, and a lost feature's guess still doubles down the levels."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, 960, 1280, N=192, dx=44.8, dy=-41.6, waves=True)
    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, pok)
    assert 16 <= kok.sum().item() <= len(pts) - 4 - 16
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    lost = valid & ~kok
    assert torch.isfinite(kp).all() and (kp[lost] - pp[lost]).abs().max().item() < 0.5


def test_fused_repeat_is_bit_identical(dev):
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, n_border=32)
    a = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    for _ in range(3):
        b = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_fused_without_refine_and_with_fewer_levels(dev):
    """refine_win 0 and a one-level pyramid go through the same kernel."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev)
    for n_levels, refine in ((3, 0), (1, 15), (0, 0)):
        kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
        pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
        assert torch.equal(kok, pok)
        assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX


def test_fused_six_and_seven_levels(dev):
    """n_levels 6 and 7 at 1280x960 (level 7 is 8 x 10 px, the last the
    level loop runs) with and without the refine pass, in both modes; the
    wrapper names the kernel's cap beyond it."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, 960, 1280, N=64, n_levels=8)
    for n_levels in (6, 7):
        for refine in (0, 15):
            kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
            pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
            assert torch.equal(kok, pok) and kok.sum().item() >= len(pts) // 2
            assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
        kp, kok = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, n_levels)
        pp, pok = klt.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, n_levels)
        assert torch.equal(kok, pok) and kok.sum().item() >= len(pts) // 2
        assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    assert min(pyr0[7].shape) == 8
    for wrapper in (klt_cuda.pyramidal_lk, klt_cuda.pyramidal_lk_pallas):
        with pytest.raises(ValueError, match=f"MAX_LEVELS = {klt_cuda.max_levels()}"):
            wrapper(pyr0, pyr1, pts, valid, 8)


@pytest.mark.parametrize("size,N,n_border", [((960, 1280), 192, 64), ((384, 512), 96, 32)])
def test_pallas_mode_matches_plain(dev, size, N, n_border):
    """The kernel's Pallas-geometry mode at the main path's shape (N = 256)
    and the dual-PAL tracker's (N = 128), border and corner points
    included: one launch, ok identical to the plain version's, positions
    within TIGHT_PX, the known shift recovered, every valid feature's
    iterations within the limit, and a bit-identical repeat."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, *size, N=N, n_border=n_border,
                                                   dx=3.3, dy=-2.6)
    before = (klt_cuda.pyramidal_lk_pallas.launches, klt_cuda.lk_pyramid.launches,
              klt_cuda.lk_level.launches)
    kp, kok, iters = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 3, return_iters=True)
    torch.cuda.synchronize()
    assert (klt_cuda.pyramidal_lk_pallas.launches, klt_cuda.lk_pyramid.launches,
            klt_cuda.lk_level.launches) == (before[0] + 1, before[1], before[2])
    pp, pok = klt.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 3)
    assert torch.equal(kok, pok)
    assert kok[:N].sum().item() >= N - 10 and 4 <= kok[N:].sum().item() < n_border
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    assert iters.shape == (len(pts), 4) and (iters[:4] == -1).all()
    assert (iters[kok] >= 0).all() and (iters <= klt.N_ITERS).all()
    for _ in range(2):
        again = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 3)
        assert torch.equal(again[0], kp) and torch.equal(again[1], kok)


def test_pallas_mode_reaches_past_the_klt_patch(dev):
    """A 9.3 px shift at level 0 alone: klt.py's geometry (offsets in [0,
    12]) loses it, the Pallas geometry's ([0, 22] x [0, 214]) keeps it, on
    the card as in the plain version."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, dx=9.3, dy=3.4, n_levels=0)
    kp, kok = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 0)
    pp, pok = klt.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 0)
    assert torch.equal(kok, pok) and kok.sum().item() >= len(pts) - 10
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    fp, fok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 0)
    assert (fok & (torch.linalg.norm(fp - truth, dim=-1) < 0.5)).sum().item() < len(pts) // 4


@pytest.mark.parametrize("dx,dy", [(9.3, 3.4), (14.6, 2.2)])
def test_pallas_mode_restages_its_band(dev, dx, dy):
    """Shifts at level 0 alone that carry windows out of the band of columns
    the Pallas mode stages around a pass's first offset, so that the kernel
    stages it again: ok identical to the plain version's, positions within
    TIGHT_PX, a bit-identical repeat, a restage count for every feature
    whose pass ran, and some feature restaged. Past ~9 px LK on this
    texture finds wrong minima too, so recovery is not asserted."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, dx=dx, dy=dy, n_levels=0)
    kp, kok, iters, restages = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 0,
                                                            return_iters=True,
                                                            return_restages=True)
    pp, pok = klt.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 0)
    assert torch.equal(kok, pok)
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    assert restages.shape == iters.shape == (len(pts), 1)
    assert torch.equal(restages < 0, iters < 0) and torch.equal(restages[:, 0] >= 0, valid)
    assert (restages > 0).any() and (restages <= iters).all()
    for _ in range(2):
        again = klt_cuda.pyramidal_lk_pallas(pyr0, pyr1, pts, valid, 0, return_restages=True)
        assert torch.equal(again[0], kp) and torch.equal(again[1], kok)
        assert torch.equal(again[2], restages)


def test_pyramid_matches_plain_and_truth(dev):
    """The level loop on the host over the one-level wrapper (refine pass
    included): five launches, agreement with the plain version, the known
    shift recovered (median error < 0.35 px, tests/test_klt_pallas.py's
    bound), and, being the same device code, ok identical to the fused
    launch's and positions within TIGHT_PX of it."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev)
    before = klt_cuda.lk_level.launches, klt_cuda.lk_pyramid.launches
    kp, kok = klt.lk_pyramid(klt_cuda.lk_level, pyr0, pyr1, pts, valid, 3, 15)
    torch.cuda.synchronize()
    assert (klt_cuda.lk_level.launches, klt_cuda.lk_pyramid.launches) == (before[0] + 5, before[1])
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert (kok == pok).float().mean().item() >= 0.99
    both = kok & pok
    assert both.sum().item() >= len(pts) - 10
    err = (kp[both] - pp[both]).abs().max().item()
    assert err < 0.05
    assert err < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    fp, fok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, fok)
    assert (kp[kok] - fp[kok]).abs().max().item() < TIGHT_PX


def test_level_step_starts_from_the_given_guess(dev):
    """A level step from a guess that is not 0, on border points too: the
    search patch is cut around pos + guess as in the plain version."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, n_border=32)
    g0 = torch.tensor([dx - 0.8, dy + 0.6], device=dev).expand(len(pts), 2).contiguous()
    kg, kok = klt_cuda.lk_level(pyr0[0], pyr1[0], pts, g0, valid)
    pg, pok = klt.track_level(pyr0[0], pyr1[0], pts, g0, valid)
    assert torch.equal(kok, pok) and kok.sum().item() >= 90
    assert (kg[kok] - pg[kok]).abs().max().item() < TIGHT_PX
    assert torch.equal(kg[:4], g0[:4])  # an invalid feature keeps its guess


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, N=8)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0].double(), pyr1[0].double(), pts.double(),
                          torch.zeros_like(pts).double(), valid)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0], pyr1[0], pts.cpu(), torch.zeros_like(pts), valid)
    with pytest.raises(ValueError):  # a window wider than a thread's run of taps allows
        klt_cuda.lk_level(pyr0[0], pyr1[0], pts, torch.zeros_like(pts), valid, 43, 5)
    launches = klt_cuda.lk_pyramid.launches
    for bad in (
        ([x.double() for x in pyr0], [x.double() for x in pyr1], pts.double(), valid),  # float64
        (pyr0, pyr1, pts.cpu(), valid),  # pts on the CPU
        (pyr0, pyr1[:3] + [pyr1[3][:, :-1].contiguous()], pts, valid),  # level shapes differ
        ([pyr0[0].t().contiguous().t()] + pyr0[1:], pyr1, pts, valid),  # non-contiguous level
    ):
        with pytest.raises(ValueError, match="lk_pyramid"):
            klt_cuda.pyramidal_lk(*bad, 3, refine_win=15)
    with pytest.raises(ValueError, match="lk_pyramid"):  # the limit is the kernel's own
        klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=300)
    with pytest.raises(ValueError, match="band"):  # only the Pallas geometry restages
        klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, return_restages=True)
    # No feature: empty results, and no launch to count.
    none = klt_cuda.pyramidal_lk(pyr0, pyr1, pts[:0], valid[:0], 3, refine_win=15)
    assert none[0].shape == (0, 2) and none[1].shape == (0,)
    assert klt_cuda.lk_pyramid.launches == launches


def test_frontend_on_cuda_runs_through_the_kernel(dev):
    """The port's FrontEnd on the card tracks through the fused kernel: one
    launch per tracked frame, none of the one-level kernel."""
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R), device=dev)
    before = klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches
    outs = [fe.process_arrays(world.render(k / 15), k / 15) for k in range(3)]
    assert (klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches) == (before[0] + 2, before[1])
    assert outs[2][4].sum() > 60


def test_frontend_use_pallas_runs_through_the_pallas_mode(dev):
    """FrontEnd(use_pallas=True) on the card: one launch of the kernel's
    Pallas mode per tracked frame, none of the other wrappers."""
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    kw = dict(max_cnt=120, min_dist=15, n_slots=160, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R),
              use_pallas=True, refine_win=15)
    fe = FrontEnd(world.camera, (world.height, world.width), device=dev, **kw)
    before = (klt_cuda.pyramidal_lk_pallas.launches, klt_cuda.lk_pyramid.launches,
              klt_cuda.lk_level.launches)
    outs = [fe.process_arrays(world.render(k / 15), k / 15) for k in range(3)]
    assert (klt_cuda.pyramidal_lk_pallas.launches, klt_cuda.lk_pyramid.launches,
            klt_cuda.lk_level.launches) == (before[0] + 2, before[1], before[2])
    assert outs[2][4].sum() > 60


def _pal_frontend(dev, seed=0, n_slots=160):
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    return world, FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                           n_slots=n_slots, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R),
                           seed=seed, device=dev)


def test_dispatch_does_not_wait_and_equals_process_arrays(dev):
    """FrontEnd.dispatch enqueues and returns: behind a busy stream the
    handle's event has not completed when dispatch is back, so nothing in it
    waited for the card. Shown on every tracked frame after the first of
    its kind, published (RANSAC's eigensolves are the kernel) and
    unpublished: each is a replay of the kind's CUDA graph (the first frame
    of a kind captures it, and a capture synchronizes). And dispatch + a
    later finalize gives what process_arrays gives, bit for bit, over 5
    tracked frames (handles finalized two frames late, as the pipeline does
    at depth 3)."""
    world, fe_a = _pal_frontend(dev)
    _, fe_b = _pal_frontend(dev)
    imgs = [world.render(k / 15) for k in range(6)]
    torch.cuda.synchronize()
    publish = [k not in (2, 4) for k in range(6)]
    sync_outs = [fe_a.process_arrays(img, k / 15, publish=publish[k])
                 for k, img in enumerate(imgs)]
    handles, late_outs = [], []
    for k, img in enumerate(imgs):
        replay = k >= 3  # frames 1 and 2 captured the published and unpublished graphs
        if replay:
            torch.cuda._sleep(int(2e8))  # keep the stream busy for ~0.1 s
        h = fe_b.dispatch(img, k / 15, publish=publish[k])
        if replay:
            assert h[1].event is not None and not h[1].event.query()
        handles.append(h)
        if len(handles) == 3:
            late_outs.append(fe_b.finalize(handles.pop(0)))
    late_outs += [fe_b.finalize(h) for h in handles]
    for a, b in zip(sync_outs, late_outs):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or ()):
            np.testing.assert_array_equal(x, y)
    assert [o is None for o in late_outs] == [True, False, True, False, True, False]
    assert sync_outs[5][4].sum() > 60
    assert {k: p.replays for k, p in fe_b._programs.items()} == {True: 2, False: 1}


def test_dual_frontend_counts_two_launches_a_frame(dev):
    """DualFrontEnd: two fused launches per tracked frame pair, one id space
    (no id handed out twice), a camera id per observation."""
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd

    world, fe0 = _pal_frontend(dev, n_slots=128)
    _, fe1 = _pal_frontend(dev, seed=1, n_slots=128)
    fe = DualFrontEnd(fe0, fe1)
    rics = [np.eye(3), np.diag([1.0, -1.0, -1.0])]
    tics = [np.array([0.0, 0.0, 0.05]), np.array([0.0, 0.0, -0.05])]
    before = klt_cuda.lk_pyramid.launches
    for k in range(4):
        out = fe.process_arrays(
            tuple(world.render_rig(k / 15, rics[c], tics[c]) for c in range(2)), k / 15)
    assert klt_cuda.lk_pyramid.launches == before + 2 * 3
    ids, bearings, vels, rows, pub, cams = out
    assert len(ids) == 256 and set(np.unique(cams)) == {0, 1}
    live = ids[ids >= 0]
    assert len(np.unique(live)) == len(live) > 100
    assert pub[cams == 0].sum() > 30 and pub[cams == 1].sum() > 30


# Publish patterns of the card's front-end graph tests (frame 0 is a
# stream's first frame): the bench's 15 Hz frames published at 10 Hz (every
# other frame) and 30 Hz frames at 10 Hz (2 of 3 unpublished).
FRONTEND_PATTERNS = {"15hz_10hz": lambda k: k % 2 == 0, "30hz_10hz": lambda k: k % 3 == 0}


@pytest.mark.parametrize("pattern", list(FRONTEND_PATTERNS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_frontend_graphs_match_eager(dev, use_pallas, pattern):
    """A FrontEnd whose tracked frames replay its published / unpublished
    CUDA graphs against one run op by op (use_graphs off) on the same 16
    frames, reset before frame 8 (14 tracked frames), through
    chip_smoke.frontend_graphs_vs_eager (phase 4g's check): status,
    new_src, positions, bearings and the finalized frames bit for bit, the
    LK and sym_eig launches of every frame equal, every replayed dispatch
    under set_sync_debug_mode("error"), and one capture a kind, at its
    first tracked frame; in both LK geometries."""
    import chip_smoke

    world, fe_g = _pal_frontend(dev)
    _, fe_e = _pal_frontend(dev)
    for fe in (fe_g, fe_e):
        fe.use_pallas = use_pallas
    frames = [(k / 15, world.render(k / 15)) for k in range(16)]
    publish = [FRONTEND_PATTERNS[pattern](k) for k in range(16)]
    lk = klt_cuda.pyramidal_lk_pallas if use_pallas else klt_cuda.lk_pyramid
    before = lk.launches
    out = chip_smoke.frontend_graphs_vs_eager("[test]", fe_g, fe_e, frames, publish, reset_at=8)
    assert out["tracked"]["n"] == 14 and lk.launches - before == 2 * 14
    assert fe_g.graph_stats()[0] == 2 and fe_e._programs == {}
    assert out["nodes"][0]["published"]["kernel"] > out["nodes"][0]["unpublished"]["kernel"]


def test_dual_frontend_graphs_match_eager(dev):
    """A DualFrontEnd (two 128-slot trackers, one id space) with each
    camera's graphs against its eager twin, 14 frame pairs at the 15 Hz /
    10 Hz pattern, reset before frame 7: bit for bit, launches equal, each
    camera's FrontEnd with programs of its own."""
    import chip_smoke
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd

    world, f0 = _pal_frontend(dev, n_slots=128)
    fes = [f0] + [_pal_frontend(dev, seed=s, n_slots=128)[1] for s in (1, 0, 1)]
    dual_g, dual_e = DualFrontEnd(*fes[:2]), DualFrontEnd(*fes[2:])
    rics = [np.eye(3), np.diag([1.0, -1.0, -1.0])]
    tics = [np.array([0.0, 0.0, 0.05]), np.array([0.0, 0.0, -0.05])]
    frames = [(k / 15, tuple(world.render_rig(k / 15, rics[c], tics[c]) for c in range(2)))
              for k in range(14)]
    publish = [FRONTEND_PATTERNS["15hz_10hz"](k) for k in range(14)]
    out = chip_smoke.frontend_graphs_vs_eager("[test]", dual_g, dual_e, frames, publish,
                                              reset_at=7)
    assert out["tracked"]["n"] == 12 and len(out["programs"]) == 2
    assert all(fe.graph_stats()[0] == 2 for fe in dual_g.fes)
    assert dual_g.fes[0]._programs[True] is not dual_g.fes[1]._programs[True]
    ids = np.concatenate([fe.ids for fe in dual_g.fes])
    live = ids[ids >= 0]
    assert len(np.unique(live)) == len(live) > 100


# ------------------------------------------------------------- sym_eig
def _spread_spd(rng, B, n, dtype, dev):
    """B symmetric matrices with eigenvalues spread over [0, 1] (gaps of at
    least 1 / (n - 1): every eigenvector well posed) in random bases."""
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    lam = np.sort(np.linspace(0.0, 1.0, n) + 0.1 / n * rng.random((B, n)), axis=-1)
    A = Q @ (lam[..., None] * np.swapaxes(Q, -1, -2))
    return torch.as_tensor(A, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(256, 4), (101, 9), (101, 3), (384, 4), (1, 3), (1, 4),
                                   (13, 4)])
def test_sym_eig_matches_eigh(dev, shape, dtype, tol):
    """The main path's shapes (the triangulation's at 256 and 384 slots, a
    RANSAC refit's single matrices) and batches that fill no whole block of
    the 4-lane path (eight matrices) or of the 16-lane one (eight):
    eigenvalues ascending and within tol of the library's, every
    eigenvector parallel to the library's (|vᵀv_ref| within tol of 1) and
    unit length."""
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    B, n = shape
    A = _spread_spd(np.random.default_rng(n), B, n, dtype, dev)
    before = sym_eig.launches
    w, V = sym_eig(A)
    torch.cuda.synchronize()
    assert sym_eig.launches == before + 1
    w_ref, V_ref = torch.linalg.eigh(A)
    assert float((w - w_ref).abs().max()) <= tol
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    dots = (V * V_ref).sum(-2).abs()
    assert float((dots - 1).abs().max()) <= 10 * tol
    assert float((V.norm(dim=-2) - 1).abs().max()) <= 10 * tol


def test_sym_eig_wrapper(dev):
    """Batch shapes pass through, a rank-deficient matrix gives its null
    vector, an empty batch launches nothing, and what the kernel does not
    take raises (no library fallback)."""
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((2, 3, 8, 9)), device=dev)
    w, V = sym_eig(X.transpose(-1, -2) @ X)  # rank 8: one null vector each
    assert w.shape == (2, 3, 9) and V.shape == (2, 3, 9, 9)
    null = V[..., :, 0]
    assert float((X @ null[..., :, None]).abs().max()) <= 1e-10
    before = sym_eig.launches
    w0, V0 = sym_eig(torch.zeros((0, 4, 4), device=dev))
    assert w0.shape == (0, 4) and sym_eig.launches == before
    for bad in (torch.zeros((3, 10, 10), device=dev), torch.zeros((3, 4, 4), dtype=torch.int32,
                                                                   device=dev),
                torch.zeros((3, 4, 5), device=dev)):
        with pytest.raises(ValueError):
            sym_eig(bad)


def _eig_check(A, w, V, tol):
    """Residual |A V - V diag(w)| and |VᵀV - I|, and the eigenvalues'
    distance to torch.linalg.eigh's, relative to the largest |eigenvalue|
    (residuals hold where eigenvectors are not well posed); ascending order."""
    w_ref = torch.linalg.eigh(A)[0]
    scale = w_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    res = (A @ V - V * w[..., None, :]).abs().amax(-1) / scale
    assert float(res.max()) <= tol, float(res.max())
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) <= tol
    assert float(((w - w_ref).abs() / scale).max()) <= tol
    assert bool((w[..., 1:] >= w[..., :-1]).all())


def _eight_point_gram(rng, B, dev):
    """B of RANSAC's f32 9×9 matrices: AᵀA of the constraint rows b2 ⊗ b1 of
    8 bearing pairs under a random motion (rank 8, one null vector)."""
    from lfvio_tpu_torch.frontend.ransac import _constraint_rows

    X = rng.standard_normal((B, 8, 3))
    X *= rng.uniform(2.0, 8.0, (B, 8, 1)) / np.linalg.norm(X, axis=-1, keepdims=True)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    X2 = X @ (R * np.linalg.det(R)).T + [0.2, -0.1, 0.05]
    unit = lambda a: torch.as_tensor(a / np.linalg.norm(a, axis=-1, keepdims=True),
                                     dtype=torch.float32, device=dev)
    A = _constraint_rows(unit(X), unit(X2))
    return A.transpose(-1, -2) @ A, A


@pytest.mark.parametrize("B", [100, 1])
def test_sym_eig_eight_point_rank8(dev, B):
    """RANSAC's shapes, [100, 9, 9] and [1, 9, 9], f32: residuals and
    eigenvalues within 1e-5 of the largest, the smallest eigenvector a null
    vector of the constraint rows, every matrix below the sweep cap."""
    from lfvio_tpu_torch.geom.eigh_cuda import MAX_SWEEPS, sym_eig

    G, rows = _eight_point_gram(np.random.default_rng(B), B, dev)
    w, V, sweeps = sym_eig(G, sweeps=True)
    torch.cuda.synchronize()
    _eig_check(G, w, V, 1e-5)
    null = (rows @ V[..., :, 0:1]).abs().amax((-1, -2))
    assert float(null.max()) <= 1e-3
    assert int(sweeps.max()) < MAX_SWEEPS and int(sweeps.min()) >= 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_sym_eig_special_matrices(dev, n, dtype, tol):
    """Each order of both group paths (4 lanes for n <= 4, 16 above) on a
    repeated eigenvalue (a threefold one in a random basis; all equal for
    n < 3), a random symmetric matrix, a rank-deficient one (B Bᵀ with B n x
    (n - 1)), at n = 3 the rank-2 EᵀE of an essential matrix [t]x R (as
    RANSAC's projection of E hands it), a diagonal matrix and the zero
    matrix: residuals and eigenvalues within tol of the largest; a diagonal
    or zero input takes no rotation (0 sweeps) and comes back exact."""
    from lfvio_tpu_torch.geom.eigh_cuda import MAX_SWEEPS, sym_eig

    rng = np.random.default_rng(n)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    rep = Q @ np.diag(([1.0, 1.0, 1.0] + list(np.linspace(2.0, 3.0, max(n - 3, 0))))[:n]) @ Q.T
    B = rng.standard_normal((n, n))
    low = rng.standard_normal((n, n - 1))
    checked = [rep, B + B.T, low @ low.T]
    if n == 3:
        t = rng.standard_normal(3)
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        E = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]]) @ R
        checked.append(E.T @ E)
    diag = np.diag(rng.standard_normal(n))
    A = torch.as_tensor(np.stack(checked + [diag, np.zeros((n, n))]), dtype=dtype, device=dev)
    k = len(checked)
    w, V, sweeps = sym_eig(A, sweeps=True)
    torch.cuda.synchronize()
    _eig_check(A[:k], w[:k], V[:k], tol)
    assert int(sweeps[:k].max()) < MAX_SWEEPS
    assert sweeps[k:].tolist() == [0, 0]
    d = torch.sort(torch.diagonal(A[k]))[0]
    assert torch.equal(w[k], d) and torch.equal(w[k + 1], torch.zeros_like(w[k + 1]))
    assert float((V[k].abs().sum(0) - 1).abs().max()) == 0.0
    assert torch.equal(V[k + 1].abs().sum(0), torch.ones(n, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_redesigned_kernels_repeat_bit_identical(dev, dtype):
    """Five launches of sym_eig on the main path's 4 x 4 and 3 x 3 inputs
    (the 4-lane path) and of proj_rows and proj_cost at window 10 are each
    bit-identical: no atomics, every sum in a fixed order."""
    import chip_smoke
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    calls = [lambda A=A.to(dtype): sym_eig(A, sweeps=True)
             for A in chip_smoke.main_path_eig_inputs(dev) if A.shape[-1] <= 4]
    state, grid, cfg = _proj_case(dev, dtype, 1, n_slots=37)
    calls += [lambda: pc.proj_rows(state, grid, cfg), lambda: (pc.proj_cost(state, grid, cfg),)]
    assert len(calls) == 5
    for call in calls:
        first = call()
        for _ in range(4):
            assert all(torch.equal(x, y) for x, y in zip(first, call()))


def _proj_window(dev, dtype, W1, F, seed=0):
    """A window of W1 frames along a curve and F features seen from it, one
    camera, on the card in ``dtype``: each feature anchored at a random
    frame, its bearings those of its point from every frame (plus 1e-3
    noise), 85% of the observations valid, 90% of the slots used, td and
    extrinsics estimated. (state, grid, cfg)."""
    import dataclasses

    from lfvio_tpu_torch.backend import FeatureGrid, WindowState
    from lfvio_tpu_torch.geom import quat_to_mat, so3_exp
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    rng = np.random.default_rng(seed)
    tt = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    t = np.linspace(0.0, 0.08 * (W1 - 1), W1)
    p = np.stack([t, 0.2 * np.sin(t), 0.1 * t], -1)
    q = so3_exp(torch.as_tensor(np.stack([0.05 * np.sin(3 * t), 0.1 * t, 0.1 * np.cos(2 * t)],
                                         -1))).numpy()
    R = quat_to_mat(torch.as_tensor(q)).numpy()
    tic, qic = np.array([0.01, -0.02, 0.005]), so3_exp(torch.as_tensor([0.02, -0.01, 0.03])).numpy()
    Rc = quat_to_mat(torch.as_tensor(qic)).numpy()
    dirs = rng.standard_normal((F, 3))
    X = p.mean(0) + dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * rng.uniform(3, 8, (F, 1))
    Pc = np.einsum("jba,fjb->fja", R, X[:, None] - p[None])  # R_jᵀ (X - p_j)
    Pc = np.einsum("ba,fjb->fja", Rc, Pc - tic)  # R_cᵀ (P_b - t_c)
    depth = np.linalg.norm(Pc, axis=-1)
    bearing = Pc / depth[..., None] + 1e-3 * rng.standard_normal((F, W1, 3))
    bearing /= np.linalg.norm(bearing, axis=-1, keepdims=True)
    anchor = rng.integers(0, W1, F)
    state = WindowState(
        p=tt(p), q=tt(q), v=tt(np.zeros((W1, 3))), ba=tt(np.zeros((W1, 3))),
        bg=tt(np.zeros((W1, 3))), tic=tt(tic), qic=tt(qic), td=tt(0.002),
        inv_depth=tt(1.0 / depth[np.arange(F), anchor]))
    grid = FeatureGrid(
        bearing=tt(bearing), velocity=tt(1e-3 * rng.standard_normal((F, W1, 3))),
        td_obs=tt(1e-3 * rng.standard_normal((F, W1))),
        valid=tt(rng.random((F, W1)) < 0.85, torch.bool), anchor=tt(anchor, torch.int64),
        used=tt(rng.random(F) < 0.9, torch.bool))
    cfg = make_window_problem(8, dtype, device=dev)["cfg"]
    return state, grid, dataclasses.replace(cfg, estimate_td=True, estimate_extrinsic=True)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("W1,F", [(41, 37), (11, 5)])
def test_proj_rows_and_cost_at_window_40_and_a_partial_block(dev, W1, F, dtype, bound):
    """proj_rows and proj_cost (and proj_normal beside them) against their
    plain versions within 1e-5 (f32) or 1e-12 (f64) of each output's scale
    (chip_smoke.proj_compare), a repeat bit-identical: at window 40 (37
    slots, 1,517 observations: 23 blocks of 64 and 45 more), and at 5 slots
    of window 10 (55 observations, part of one block)."""
    import chip_smoke

    state, grid, cfg = _proj_window(dev, dtype, W1, F)
    errs, _, identical = chip_smoke.proj_compare(state, grid, cfg)
    assert identical
    assert max(errs.values()) <= bound, errs


def test_sym_eig_sweeps_below_the_cap_at_the_main_path_inputs(dev):
    """The inputs the main path hands the kernel (chip_smoke.py's
    recording: a triangulation at 256 slots and one RANSAC): no matrix stops
    at MAX_SWEEPS."""
    import chip_smoke
    from lfvio_tpu_torch.geom.eigh_cuda import MAX_SWEEPS, sym_eig

    for A in chip_smoke.main_path_eig_inputs(dev):
        sweeps = sym_eig(A, sweeps=True)[2]
        assert int(sweeps.max()) < MAX_SWEEPS, (tuple(A.shape), int(sweeps.max()))


def test_published_dispatch_does_not_wait(dev):
    """A published frame's dispatch (RANSAC's eigensolves now the kernel)
    enqueues and returns behind a busy stream: its event has not completed
    when dispatch is back, and no call in it is a synchronizing one."""
    world, fe = _pal_frontend(dev)
    imgs = [world.render(k / 15) for k in range(3)]
    fe.process_arrays(imgs[0], 0.0)
    fe.process_arrays(imgs[1], 1 / 15)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = fe.dispatch(imgs[2], 2 / 15, publish=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert h[1].event is not None and not h[1].event.query()
    assert fe.finalize(h)[4].sum() > 60


def test_estimator_graphs_match_eager_f64(dev):
    """One replay of each program's CUDA graph (solve, relocalization solve,
    both marginalizations) against the same function run eagerly on the
    same inputs, f64, within 1e-9 of the scale (chip_smoke.py phase 14);
    the solve also at the packed caps 8, 1 and 3 on a perturbed window, each
    running as many LM iterations as its cap, and at the stream window's
    own early plateau ("solve")."""
    import chip_smoke

    errs = chip_smoke.phase_graphs_f64(dev)
    assert set(errs) == {"solve", "solve cap 8", "solve cap 1", "solve cap 3", "marg_old",
                         "marg_new", "relo"}
    assert max(errs.values()) <= 1e-9


# ------------------------------------------------ csrc/proj_factor.cu
def _proj_case(dev, dtype, n_cams, n_slots=32):
    """make_window_problem's window at ``n_slots`` (tracks of 5 frames from
    varied anchors, td and extrinsics estimated) on the card in ``dtype``;
    with two cameras, chip_smoke's dual-camera form of it."""
    import dataclasses

    import chip_smoke
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    if n_cams == 2:
        state, grid, cfg = chip_smoke.dual_camera_inputs(dev, n_slots)
        cast = lambda x: x.to(dtype) if x.is_floating_point() else x
        state = type(state)(**{f.name: cast(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
        grid = type(grid)(**{f.name: None if getattr(grid, f.name) is None
                             else cast(getattr(grid, f.name)) for f in dataclasses.fields(grid)})
        return state, grid, cfg
    pb = make_window_problem(n_slots, dtype, n_obs_frames=5, device=dev)
    return pb["state"], pb["grid"], pb["cfg"]


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_cams", [1, 2])
def test_proj_factor_matches_plain(dev, dtype, bound, n_cams):
    """The rows, the normal equations (H_pp, H_pl, H_ll, b_p, b_l and the
    cost terms of proj_normal) and the cost of the three kernels against
    their plain versions on the same inputs, within 1e-5 (f32: sums in
    another order) or 1e-12 (f64) of each output's scale
    (chip_smoke.proj_compare), and a repeat bit-identical."""
    import chip_smoke

    errs, _, identical = chip_smoke.proj_compare(*_proj_case(dev, dtype, n_cams))
    assert identical
    assert max(errs.values()) <= bound, errs


def test_proj_factor_flags_off_and_dropped_observations(dev):
    """With both estimate flags off the extrinsic and td rows and columns
    are exact zeros; an unused slot and a feature with |λ| < 1e-8 give
    finite rows; every output still equals the plain version (f64)."""
    import dataclasses

    import chip_smoke
    from lfvio_tpu_torch.backend import proj_cuda as pc

    state, grid, cfg = _proj_case(dev, torch.float64, 1)
    cfg = dataclasses.replace(cfg, estimate_td=False, estimate_extrinsic=False)
    used = grid.used.clone()
    used[3] = False
    lam = state.inv_depth.clone()
    lam[5] = 3e-9
    state, grid = state.replace(inv_depth=lam), grid.replace(used=used)
    errs, _, identical = chip_smoke.proj_compare(state, grid, cfg)
    assert identical and max(errs.values()) <= 1e-12, errs
    rows = pc.proj_rows(state, grid, cfg)
    H_pp, H_pl, _, b_p, _, _ = pc.proj_normal(state, grid, cfg, 1)
    W1 = grid.valid.shape[1]
    assert bool((H_pp[15 * W1:] == 0).all()) and bool((H_pp[:, 15 * W1:] == 0).all())
    assert bool((b_p[6 * W1:] == 0).all()) and bool((H_pl[6 * W1:] == 0).all())
    assert bool(torch.isfinite(rows[1]).all()) and bool((rows[1][3] == 0).all())


def test_proj_wrappers_reject_what_the_kernels_do_not_take(dev):
    """Wrong dtype, shape, device mix or a strided input raise; nothing
    falls back to the plain version."""
    from lfvio_tpu_torch.backend import proj_cuda as pc

    state, grid, cfg = _proj_case(dev, torch.float32, 1)
    bad = [
        (state.replace(p=state.p.to(torch.float16)), grid),
        (state.replace(p=state.p[:-1]), grid),
        (state, grid.replace(bearing=grid.bearing.cpu())),
        (state, grid.replace(bearing=grid.bearing.transpose(0, 1).contiguous().transpose(0, 1))),
        (state, grid.replace(anchor=grid.anchor.to(torch.int32))),
        (state.replace(inv_depth=state.inv_depth.double()), grid),
    ]
    for s, g in bad:
        for fn in (pc.proj_rows, pc.proj_cost, lambda s, g, c: pc.proj_normal(s, g, c, 1)):
            with pytest.raises(ValueError):
                fn(s, g, cfg)
    with pytest.raises(ValueError):  # the state has one camera
        pc.proj_normal(state, grid, cfg, 2)


@pytest.mark.parametrize("n_cams", [1, 2])
def test_proj_normal_enumeration_paths(dev, n_cams):
    """proj_normal's tiles find their observations through the anchors; every
    way of doing so against normal_plain in f64, within 1e-12 of each
    output's scale, a repeat bit-identical, with both estimate flags on and
    off: 37 slots (not a multiple of a block's 4 features or of a cluster's
    8 ranks), every feature anchored at frame 0, every one at the last
    frame, one feature with a single kept observation, and the anchors' own
    observations marked valid (the mask drops them)."""
    import dataclasses

    import chip_smoke

    state, grid, cfg = _proj_case(dev, torch.float64, n_cams, n_slots=37)
    F, W1 = grid.valid.shape
    every = torch.ones_like(grid.valid)
    one = grid.valid.clone()
    one[0] = False
    one[0, (int(grid.anchor[0]) + 1) % W1] = True
    own = grid.valid.clone()
    own[torch.arange(F, device=dev), grid.anchor] = True
    layouts = {
        "every feature anchored at frame 0": grid.replace(
            anchor=torch.zeros_like(grid.anchor), valid=every),
        "every feature anchored at the last frame": grid.replace(
            anchor=torch.full_like(grid.anchor, W1 - 1), valid=every),
        "a feature with one kept observation": grid.replace(valid=one),
        "the anchors' own observations valid": grid.replace(valid=own),
    }
    assert int((one[0] & (torch.arange(W1, device=dev) != grid.anchor[0])).sum()) == 1
    for flags in (True, False):
        c = dataclasses.replace(cfg, estimate_td=flags, estimate_extrinsic=flags)
        for name, g in layouts.items():
            errs, _, identical = chip_smoke.proj_compare(state, g, c)
            assert identical and max(errs.values()) <= 1e-12, (name, flags, errs)


def test_proj_launches_counted_at_graph_replay(dev):
    """assemble_normal_equations and total_cost as a DeviceProgram: each
    replay counts one normal-equation launch, one cost launch and no rows
    launch."""
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.solver import assemble_normal_equations, total_cost
    from lfvio_tpu_torch.device import DeviceProgram
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(32, torch.float32, n_obs_frames=5, device=dev)
    st = pb["state"]
    imu = [torch.as_tensor(pb[k], dtype=torch.float32, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, st.ba[:-1], st.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    args = (pb["grid"], pre, si, ok, pb["prior"], pb["gravity"], pb["cfg"])

    def step(s):
        return assemble_normal_equations(s, *args)[:5], total_cost(s, *args)

    prog = DeviceProgram(step)
    eager = step(st)
    prog(st)
    kernels = (pc.proj_rows, pc.proj_normal, pc.proj_cost)
    before = [k.launches for k in kernels]
    for _ in range(3):
        out = prog(st)
    torch.cuda.synchronize()
    after = [k.launches for k in kernels]
    assert [a - b for a, b in zip(after, before)] == [0, 3, 3]
    for x, y in zip((*out[0], out[1]), (*eager[0], eager[1])):
        assert float((x - y).abs().max()) <= 1e-5 * max(float(y.abs().max()), 1.0)


# ------------------------------------------------ csrc/imu_factor.cu
def _imu_window(dev, dtype=torch.float64, W1=11):
    """chip_smoke.imu_window: the biases off the preintegration's
    linearization point, interval 1 invalid (none at W1 = 2, whose one
    interval is valid)."""
    import chip_smoke

    return chip_smoke.imu_window(dev, dtype, W1, invalid=1 if W1 > 2 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("W1", [2, 11, 21, 41])
def test_imu_factor_matches_plain(dev, dtype, W1):
    """The rows, the normal equations (H_pp, b_p and the cost terms of
    imu_normal) and the cost of the three kernels against their plain
    versions at window 1, 10, 20 and 40, the biases off the preintegration's
    linearization point and interval 1 invalid (at window 1 none), and each
    cost output against Σ r_w² of the rows, within chip_smoke.IMU_BOUNDS
    (f32: sums in another order; f64) of each output's scale
    (chip_smoke.imu_compare), and a repeat bit-identical."""
    import chip_smoke

    bound = chip_smoke.IMU_BOUNDS[str(dtype).split(".")[-1]]
    errs, _, identical = chip_smoke.imu_compare(_imu_window(dev, dtype, W1))
    assert identical
    assert max(errs.values()) <= bound, errs


def test_imu_invalid_interval_and_in_place_sums(dev):
    """An invalid interval's rows and cost are exact zeros; imu_normal adds
    into the H_pp and b_p it is given, in place, and touches no extrinsic or
    td row or column (f64)."""
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    args = _imu_window(dev)
    state = args[0]
    W1 = state.p.shape[0]
    r, J30 = ic.imu_rows(*args)
    cost = ic.imu_cost(*args)
    assert bool((r[1] == 0).all()) and bool((J30[1] == 0).all()) and float(cost[1]) == 0.0
    D = pose_dim(W1, n_cams_of(state))
    gen = torch.Generator(device=dev).manual_seed(0)
    H0 = torch.randn((D, D), dtype=torch.float64, device=dev, generator=gen)
    b0 = torch.randn(D, dtype=torch.float64, device=dev, generator=gen)
    H, b = H0.clone(), b0.clone()
    out = ic.imu_normal(H, b, *args)
    assert out[0].data_ptr() == H.data_ptr() and out[1].data_ptr() == b.data_ptr()
    Hp, bp, cp = ic.imu_normal_plain(H0.clone(), b0.clone(), *args)
    scale = float(Hp.abs().max())
    assert float((H - Hp).abs().max()) <= 1e-13 * scale
    assert float((b - bp).abs().max()) <= 1e-13 * float(bp.abs().max())
    assert torch.equal(H[15 * W1:], H0[15 * W1:]) and torch.equal(H[:, 15 * W1:], H0[:, 15 * W1:])
    assert torch.equal(b[15 * W1:], b0[15 * W1:])
    assert float((out[2] - cp).abs().max()) <= 1e-13 * float(cp.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_imu_kernels_repeat_bit_identical_at_window_40(dev, dtype):
    """At W1 = 41 five launches of each kernel on the same inputs give the
    same bits (no atomics, a fixed order of every sum), and imu_normal adds
    into H_pp and b_p entries of the window's own scale in place: an addend
    dropped or written twice would be of that scale."""
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    args = _imu_window(dev, dtype, 41)
    D = pose_dim(41, n_cams_of(args[0]))
    zeros = lambda: (torch.zeros((D, D), dtype=dtype, device=dev),
                     torch.zeros(D, dtype=dtype, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    Hs, bs, _ = ic.imu_normal_plain(*zeros(), *args)
    H0 = float(Hs.abs().max()) * torch.randn((D, D), dtype=dtype, device=dev, generator=gen)
    b0 = float(bs.abs().max()) * torch.randn(D, dtype=dtype, device=dev, generator=gen)
    runs = {"imu_rows": lambda: ic.imu_rows(*args), "imu_cost": lambda: (ic.imu_cost(*args),),
            "imu_normal": lambda: ic.imu_normal(H0.clone(), b0.clone(), *args)}
    for name, fn in runs.items():
        first = fn()
        for _ in range(4):
            assert all(torch.equal(x, y) for x, y in zip(first, fn())), name
    H, b, _ = runs["imu_normal"]()
    bound = 1e-13 if dtype == torch.float64 else 1e-5
    assert float((H - (H0 + Hs)).abs().max()) <= bound * float(Hs.abs().max())
    assert float((b - (b0 + bs)).abs().max()) <= bound * float(bs.abs().max())


def test_imu_wrappers_reject_what_the_kernels_do_not_take(dev):
    """Wrong dtype, shape, device mix or a strided input raise; nothing
    falls back to the plain version."""
    import dataclasses

    from lfvio_tpu_torch.backend import imu_cuda as ic

    state, pre, si, ok, g = _imu_window(dev, torch.float32)
    D = 15 * state.p.shape[0] + 7
    H = torch.zeros((D, D), device=dev)
    b = torch.zeros(D, device=dev)
    strided = pre.delta_q.transpose(0, 1).contiguous().transpose(0, 1)
    bad = [
        (state.replace(p=state.p.to(torch.float16)), pre, si, ok, g),
        (state.replace(v=state.v[:-1]), pre, si, ok, g),
        (state, dataclasses.replace(pre, delta_q=strided), si, ok, g),
        (state, dataclasses.replace(pre, jacobian=pre.jacobian.cpu()), si, ok, g),
        (state, pre, si.double(), ok, g),
        (state, pre, si, ok.to(torch.int32), g),
        (state, pre, si, ok, g[:2]),
    ]
    for args in bad:
        for fn in (ic.imu_rows, ic.imu_cost, lambda *a: ic.imu_normal(H, b, *a)):
            with pytest.raises(ValueError):
                fn(*args)
    with pytest.raises(ValueError):  # H_pp of a two-camera layout
        ic.imu_normal(torch.zeros((D + 6, D + 6), device=dev), b, state, pre, si, ok, g)


def test_imu_launches_counted_at_graph_replay(dev):
    """lm_solve at cap 8 and marginalize_old_qr as DevicePrograms (f64): each
    solve replay counts an imu_normal launch a linearization it ran and an
    imu_cost launch a cost (1 + its iterations), read from its conditional
    bodies' counters (``collect_launches``), and no rows launch; each
    MARGIN_OLD replay one imu_rows launch and nothing else; the replays
    equal the eager functions within 1e-9 of the scale
    (test_estimator_graphs_match_eager_f64's bound)."""
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.marginalize import marginalize_old_qr
    from lfvio_tpu_torch.backend.solver import lm_solve
    from lfvio_tpu_torch.device import DeviceProgram, collect_launches
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(32, torch.float64, n_obs_frames=5, device=dev)
    st = pb["state"]
    imu = [torch.as_tensor(pb[k], dtype=torch.float64, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, st.ba[:-1], st.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    cfg = pb["cfg"]
    assert cfg.max_iterations == 8
    solve = lambda s: lm_solve(s, pb["grid"], pre, si, ok, pb["prior"], pb["gravity"], cfg,
                               counts=True)
    marg = lambda s: marginalize_old_qr(s, pb["grid"], pre, si, ok, pb["prior"], pb["gravity"],
                                        cfg)
    iters, lins = (int(x) for x in solve(st)[4:])
    kernels = (ic.imu_rows, ic.imu_normal, ic.imu_cost)
    for fn, want in ((solve, [0, lins, 1 + iters]), (marg, [1, 0, 0])):
        prog = DeviceProgram(fn)
        eager = fn(st)
        prog(st)
        collect_launches()
        before = [k.launches for k in kernels]
        for _ in range(2):
            out = prog(st)
        torch.cuda.synchronize()
        collect_launches()
        assert [k.launches - b for k, b in zip(kernels, before)] == [2 * w for w in want]
        for x, y in zip(_leaves(out), _leaves(eager)):
            assert float((x - y).abs().max()) <= 1e-9 * max(float(y.abs().max()), 1.0)


def _leaves(x):
    from lfvio_tpu_torch.device import _leaves as leaves

    return [t for t in leaves(x, []) if t.is_floating_point()]


# ------------------------------------------------ csrc/proj_factor.cu: the relo rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cams,n_slots", [(1, 256), (2, 64)])
def test_relo_kernels_match_plain(dev, dtype, n_cams, n_slots):
    """relo_normal (H6, H_pl6, H_ll, b6, b_l on zero sums) and relo_cost
    against their plain versions on chip_smoke.relo_window (256 slots,
    window 10, mono; 64 slots with anchors on both cameras), within 1e-5
    (f32) or 1e-12 (f64) of each output's scale, a repeat bit-identical, and
    the planted faults (a zero cost, a dropped match, the loop side's
    extrinsic block in the anchor camera's columns) rejected."""
    import chip_smoke

    args = chip_smoke.relo_window(dev, dtype, n_cams, n_slots)
    bound = chip_smoke.RELO_BOUNDS[str(dtype).split(".")[-1]]
    errs, _, identical = chip_smoke.relo_compare(args)
    assert identical
    assert max(errs.values()) <= bound, errs
    faults = chip_smoke.relo_planted_faults(args)
    assert len(faults) == (3 if n_cams == 2 else 2)
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.RELO_FAULT_OUTPUTS[fault]), (fault, fe)


@pytest.mark.parametrize("n_cams", [1, 2])
@pytest.mark.parametrize("layout", ["front", "spread"])
@pytest.mark.parametrize("n_slots", [256, 384])
@pytest.mark.parametrize("W1", [11, 21])
def test_relo_kernels_match_plain_across_layouts(dev, W1, n_slots, layout, n_cams):
    """relo_normal and relo_cost against their plain versions on
    chip_smoke.relo_layout: windows of 11 and 21 frames, 256 and 384 slots
    (32 and 48 slots a block of relo_normal's cluster), anchors 96% at
    frame 0 as on the main path ("front", where one tile holds nearly every
    feature) or spread evenly ("spread", many small tiles), one camera, or
    two with the extrinsics estimated; within [14r]'s f64 bound of each
    output's scale, a repeat bit-identical, every planted fault rejected.
    f64: on these windows the f32 plain version's λ-column outputs (H_pl6,
    H_ll) are themselves up to 1.2e-5 of [14r]'s scale from f64 arithmetic
    on the same inputs; test_relo_kernels_f32_across_layouts holds the f32
    kernels there against f64 arithmetic."""
    import chip_smoke

    dtype = torch.float64
    args = chip_smoke.relo_layout(dev, dtype, W1, n_slots, n_cams, layout)
    bound = chip_smoke.RELO_BOUNDS["float64"]
    errs, _, identical = chip_smoke.relo_compare(args)
    assert identical
    assert max(errs.values()) <= bound, errs
    faults = chip_smoke.relo_planted_faults(args)
    assert len(faults) == (3 if n_cams == 2 else 2)
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.RELO_FAULT_OUTPUTS[fault]), (fault, fe)


@pytest.mark.parametrize("n_cams", [1, 2])
@pytest.mark.parametrize("layout", ["front", "spread"])
@pytest.mark.parametrize("n_slots", [256, 384])
@pytest.mark.parametrize("W1", [11, 21])
def test_relo_kernels_f32_across_layouts(dev, W1, n_slots, layout, n_cams):
    """The float32 kernels on test_relo_kernels_match_plain_across_layouts'
    windows against the plain version run in float64 on the float32 inputs
    upcast (chip_smoke.relo_upcast), within RELO_F32_EXACT_BOUND of each
    output's scale ([14r]'s scale of the upcast inputs), a repeat
    bit-identical, every planted fault rejected."""
    import chip_smoke

    args = chip_smoke.relo_layout(dev, torch.float32, W1, n_slots, n_cams, layout)
    bound = chip_smoke.RELO_F32_EXACT_BOUND
    out, again = chip_smoke.relo_outputs(args), chip_smoke.relo_outputs(args)
    assert all(torch.equal(out[n], again[n]) for n in out)
    exact = chip_smoke.relo_outputs(chip_smoke.relo_upcast(args), plain=True)
    errs = chip_smoke.relo_errors({n: x.double() for n, x in out.items()}, exact,
                                  chip_smoke.relo_scales(chip_smoke.relo_upcast(args)))
    assert max(errs.values()) <= bound, errs
    faults = chip_smoke.relo_planted_faults(args)
    assert len(faults) == (3 if n_cams == 2 else 2)
    for fault, fe in faults.items():
        assert all(fe[n] > bound for n in chip_smoke.RELO_FAULT_OUTPUTS[fault]), (fault, fe)


@pytest.mark.parametrize("n_cams", [1, 2])
def test_relo_normal_at_its_limits(dev, n_cams):
    """relo_normal in float64 (one camera; two with the extrinsics
    estimated) at MAX_SLOTS slots, over 21 frames (window 20) and over the
    most frames the wrapper takes there (MAX_FRAMES, or fewer where a
    block's shared memory holds no more): against the plain version within
    [14r]'s f64 bound, a repeat bit-identical; one slot or one frame more
    is refused with its reason."""
    import chip_smoke
    from lfvio_tpu_torch.backend import relo_cuda as rc

    F, dt = rc.MAX_SLOTS, torch.float64

    def fits(W1):
        need, limit = rc.normal_smem(F, W1, n_cams, n_cams > 1, dt, dev)
        return W1 <= rc.MAX_FRAMES and need <= limit

    W_max = 21
    while fits(W_max + 1):
        W_max += 1
    for W1 in (21, W_max):
        errs, _, identical = chip_smoke.relo_compare(
            chip_smoke.relo_layout(dev, dt, W1, F, n_cams, "spread"))
        assert identical
        assert max(errs.values()) <= chip_smoke.RELO_BOUNDS["float64"], (W1, errs)
    refused = ((F + 1, 21, "at most"),
               (F, W_max + 1, "at most" if W_max == rc.MAX_FRAMES else "shared memory"))
    for n_slots, W1, why in refused:
        with pytest.raises(ValueError, match=why):
            chip_smoke.relo_outputs(chip_smoke.relo_layout(dev, dt, W1, n_slots, n_cams, "spread"))


@pytest.mark.parametrize("estimate_extrinsic", [True, False])
def test_relo_normal_adds_in_place(dev, estimate_extrinsic):
    """relo_normal adds into the sums it is given and returns them: on a
    random base, kernel = base + the plain version's terms (f64, two
    cameras); with the extrinsic not estimated its rows and columns keep the
    base's values exactly."""
    import dataclasses

    import chip_smoke
    from lfvio_tpu_torch.backend import relo_cuda as rc

    state, grid, cfg, relo = chip_smoke.relo_window(dev, torch.float64, 2)
    cfg = dataclasses.replace(cfg, estimate_extrinsic=estimate_extrinsic)
    F, W1 = grid.valid.shape
    D6 = 15 * W1 + 12 + 1 + 6
    g = torch.Generator(device=dev).manual_seed(0)
    base = [torch.randn(s, dtype=torch.float64, device=dev, generator=g)
            for s in ((D6, D6), (D6, F), (F,), (D6,), (F,))]
    sums = [b.clone() for b in base]
    out = rc.relo_normal(*sums, state, grid, *relo, cfg)
    assert all(o is s for o, s in zip(out, sums))
    zeros = [torch.zeros_like(b) for b in base]
    terms = rc.relo_normal_plain(*zeros, state, grid, *relo, cfg)
    for o, b, term in zip(out, base, terms):
        assert float((o - (b + term)).abs().max()) <= 1e-12 * max(float(term.abs().max()), 1.0)
    ex = slice(15 * W1, 15 * W1 + 12)
    if not estimate_extrinsic:
        assert torch.equal(out[0][ex], base[0][ex]) and torch.equal(out[0][:, ex], base[0][:, ex])
        assert torch.equal(out[1][ex], base[1][ex]) and torch.equal(out[3][ex], base[3][ex])


def test_relo_wrappers_reject_what_the_kernels_do_not_take(dev):
    """Wrong dtype, shape, device mix or a strided input raise; nothing
    falls back to the plain version."""
    import chip_smoke
    from lfvio_tpu_torch.backend import relo_cuda as rc

    state, grid, cfg, (rp, rq, rb, rm) = chip_smoke.relo_window(dev, torch.float32, 1, 32)
    F, W1 = grid.valid.shape
    D6 = 15 * W1 + 6 + 1 + 6
    z = lambda *s: torch.zeros(s, device=dev)
    sums = (z(D6, D6), z(D6, F), z(F), z(D6), z(F))
    bad = [(rp.double(), rq, rb, rm), (rp, rq, rb[:-1], rm), (rp, rq, rb, rm.float()),
           (rp.cpu(), rq, rb, rm), (rp, rq, torch.zeros((3, F), device=dev).T, rm)]
    for relo in bad:
        with pytest.raises(ValueError):
            rc.relo_cost(state, grid, *relo, cfg)
        with pytest.raises(ValueError):
            rc.relo_normal(*sums, state, grid, *relo, cfg)
    with pytest.raises(ValueError):  # the sums of the un-augmented layout
        rc.relo_normal(z(D6 - 6, D6 - 6), *sums[1:], state, grid, rp, rq, rb, rm, cfg)
    with pytest.raises(ValueError):  # a strided H6
        rc.relo_normal(z(D6, D6).T, *sums[1:], state, grid, rp, rq, rb, rm, cfg)


def test_relo_launches_counted_at_graph_replay(dev):
    """lm_solve_relo at cap 8 as a DeviceProgram (f64, two cameras): each
    replay counts a relo_normal launch a linearization it ran and a
    relo_cost launch a cost (1 + its iterations), as many as the
    projection's normal and cost launches; the replay equals the eager
    function within 1e-9 of the scale, and another loop pose copied into
    its static inputs gives the eager result at that pose."""
    import chip_smoke
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.relo import lm_solve_relo
    from lfvio_tpu_torch.backend.state import PriorFactor
    from lfvio_tpu_torch.device import DeviceProgram, collect_launches
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    state, grid, cfg, relo = chip_smoke.relo_window(dev, torch.float64, 2)
    pb = make_window_problem(64, torch.float64, n_obs_frames=5, device=dev)
    imu = [torch.as_tensor(pb[k], dtype=torch.float64, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, state.ba[:-1], state.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    prior = PriorFactor.empty(torch.float64, grid.valid.shape[1], dev, n_cams=2)
    assert cfg.max_iterations == 8

    def solve(rp, rq):
        out = lm_solve_relo(state, grid, pre, si, ok, prior, pb["gravity"], cfg, rp, rq,
                            *relo[2:], counts=True)
        return out[:3] + out[-2:]

    kernels = (rc.relo_normal, rc.relo_cost, pc.proj_normal, pc.proj_cost)
    prog = DeviceProgram(solve)
    eager = solve(*relo[:2])
    iters, lins = int(eager[3]), int(eager[4])
    prog(*relo[:2])
    collect_launches()
    before = [k.launches for k in kernels]
    for _ in range(2):
        out = prog(*relo[:2])
    torch.cuda.synchronize()
    collect_launches()
    want = [lins, 1 + iters] * 2
    assert [k.launches - b for k, b in zip(kernels, before)] == [2 * w for w in want]
    assert torch.equal(out[3], eager[3]) and torch.equal(out[4], eager[4])
    for x, y in zip(_leaves(out), _leaves(eager)):
        assert float((x - y).abs().max()) <= 1e-9 * max(float(y.abs().max()), 1.0)
    rp2 = relo[0] + 0.02
    out2, eager2 = _leaves(prog(rp2, relo[1])), _leaves(solve(rp2, relo[1]))
    for x, y in zip(out2, eager2):
        assert float((x - y).abs().max()) <= 1e-9 * max(float(y.abs().max()), 1.0)


# ------------------------------------------------ the LM's conditional blocks
def _lm_case(dev, n_slots=32):
    """make_window_problem's f64 window on the card, preintegrated and
    whitened: (state, the rest of lm_solve's arguments up to cfg, cfg)."""
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(n_slots, torch.float64, n_obs_frames=5, device=dev)
    st = pb["state"]
    imu = [torch.as_tensor(pb[k], dtype=torch.float64, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, st.ba[:-1], st.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    return st, (pb["grid"], pre, si, ok, pb["prior"], pb["gravity"]), pb["cfg"]


@pytest.mark.parametrize("case", ["limit1", "limit3", "limit8", "plateau"])
def test_lm_blocks_graph_matches_eager(dev, case):
    """lm_solve with the device limit as a DeviceProgram's input (f64): its
    iterations and linearizations are IF nodes, so a replay at limit 1, 3
    and 8 and at an early plateau (cost_tol 0.3) runs only what the eager
    masked form keeps: the replay equals it within 1e-9 of the scale, runs
    the same iterations and linearizations, and launches proj_normal /
    imu_normal once a linearization and proj_cost / imu_cost once a cost
    (1 + the iterations) a replay; one graph serves every limit."""
    import dataclasses

    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.solver import lm_solve
    from lfvio_tpu_torch.device import DeviceProgram, collect_launches

    st, args, cfg = _lm_case(dev)
    if case == "plateau":
        cfg = dataclasses.replace(cfg, cost_tol=0.3)
    limit = {"limit1": 1, "limit3": 3}.get(case, 8)
    solve = lambda s, lim: lm_solve(s, *args, cfg, limit=lim, counts=True)
    prog = DeviceProgram(solve)
    other = torch.tensor(8 if limit != 8 else 2, dtype=torch.int32, device=dev)
    prog(st, other)  # captured at another limit
    lim = torch.tensor(limit, dtype=torch.int32, device=dev)
    eager = solve(st, lim)
    iters, lins = int(eager[4]), int(eager[5])
    kernels = (pc.proj_normal, ic.imu_normal, pc.proj_cost,
               ic.imu_cost, pc.proj_rows)
    torch.cuda.synchronize()
    collect_launches()
    before = [k.launches for k in kernels]
    out = prog(st, lim)
    torch.cuda.synchronize()
    collect_launches()
    assert [k.launches - b for k, b in zip(kernels, before)] == [lins, lins, 1 + iters,
                                                                  1 + iters, 0]
    assert (int(out[4]), int(out[5])) == (iters, lins)
    assert 1 <= lins <= iters <= limit
    if case == "plateau":
        assert iters < 8
    for x, y in zip(_leaves(out), _leaves(eager)):
        assert float((x - y).abs().max()) <= 1e-9 * max(float(y.abs().max()), 1.0)


def test_estimator_one_graph_a_kind_whatever_the_cap(dev):
    """An f64 bearing stream on the card (64 slots): the estimator holds one
    solve graph and one relocalization graph (captured at the first solve);
    a wall budget that binds afterwards (a cap of 2, 1 when marginalizing
    old) captures nothing more, and its solves run no more iterations than
    it allows."""
    import chip_smoke
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device=dev)
    pts = chip_smoke.make_landmarks()
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=torch.float64, device=dev))
    pipe = VioPipeline(chip_smoke.BearingFrontEnd(world, pts), est)
    chip_smoke.run_bearing_stream(pipe, world, 1.2)
    assert est.solver_flag == est.NON_LINEAR
    assert set(est._programs) == {("solve",), ("relo",), ("marg_old",)}
    graphs = est.graph_stats()[0]
    assert graphs == 3
    n = len(est.lm_runs)
    est._iter_time, est.cfg.max_solver_time = 0.01, 0.025
    chip_smoke.run_bearing_stream(pipe, world, 0.3, t0=1.2)
    assert est.graph_stats()[0] == graphs and set(est._programs) == {
        ("solve",), ("relo",), ("marg_old",)}
    after = est.lm_runs[n:]
    assert len(after) >= 4 and all(1 <= lins <= it <= 2 for it, lins, _ in after), after


def test_capture_raises_without_conditional_nodes(dev, monkeypatch):
    """Where torch offers no CUDA-graph conditional nodes, capturing the LM
    raises, naming them; nothing falls back to a masked graph."""
    from lfvio_tpu_torch import device
    from lfvio_tpu_torch.backend.solver import lm_solve

    st, args, cfg = _lm_case(dev, n_slots=16)
    monkeypatch.setattr(device, "POOL_ROUTING", device.POOL_ROUTING + ("no_such_call",))
    prog = device.DeviceProgram(lambda s: lm_solve(s, *args, cfg)[0])
    with pytest.raises(RuntimeError, match="conditional nodes"):
        prog(st)
    assert prog.graph is None


# ------------------------------------------------ csrc/marg_qr.cu: the marginalizations' QR
def _marg_window(dev, dtype, n_slots=256, n_cams=1, seed=0):
    """chip_smoke.marg_window: make_window_problem's window on the card
    (tracks of 5 frames, anchors spread; with ``n_cams`` = 2 a second
    extrinsic and a random camera an observation) as MARGIN_OLD's
    arguments."""
    import chip_smoke

    return chip_smoke.marg_window(dev, dtype, n_slots, n_cams, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cams,n_slots", [(1, 256), (2, 64)])
def test_marg_kernels_match_plain(dev, dtype, n_cams, n_slots):
    """marg_depth and marg_qr against their plain versions on a MARGIN_OLD
    window and its SECOND_NEW stack (chip_smoke.marg_compare: rows slot by
    slot, RᵀR against AᵀA, and the kept information against the plain
    version's, in f32 run in f64 on the stack upcast, each within
    chip_smoke.marg_bound), repeats bit-identical, and each planted fault
    of chip_smoke.MARG_FAULTS above chip_smoke.MARG_BOUNDS."""
    import chip_smoke

    args = _marg_window(dev, dtype, n_slots, n_cams)
    name = str(dtype).split(".")[-1]
    bound = chip_smoke.MARG_BOUNDS[name]
    cases = [(args, "old"), ((args[0], args[5]), "new")]
    if n_cams == 1:  # and marg_qr's panels: C = 173, 323 (no multiple of 16), 384 (the widest),
        # whole panels whose reflections all skip, an empty column in mid-panel
        cases += [(chip_smoke.marg_panel_stack(dev, dtype, C), "stack") for C in (173, 323, 384)]
    for case in cases:
        depth_args, A, head, m = chip_smoke.marg_stage_inputs(*case)
        errs, _, _, identical = chip_smoke.marg_compare(depth_args, A, head, m)
        assert identical and all(v <= chip_smoke.marg_bound(n, name) for n, v in errs.items()), errs
        faults = chip_smoke.marg_planted_faults(depth_args, A, head, m)
        assert all(v > bound for f in faults.values() for v in f.values()), faults


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_marg_qr_without_information_in_some_columns(dev, dtype):
    """marg_qr of a stack with a dense head, empty columns, a kept column
    the others span and all-zero rows, its 840 rows after the head in
    blocks of 840, 300 and 100 rows, each padded with zero rows to whole
    leaves (``marg_cuda.leaves``: 4, 5 and 9 leaves of 256 rows;
    zero rows carry no information): RᵀR = AᵀA within the bound of its
    scale, the empty columns' rows of R zero, the lower triangle zero,
    repeats bit-identical, and the same information below the first 20
    (dropped) columns whatever the leaves, up to rounding (a Schur
    complement on a non-singular dropped block; r0ᵀr0 aside, which the
    spanned column's rounding-level pivot splits with the last row)."""
    import chip_smoke
    from lfvio_tpu_torch.backend import marg_cuda as mc

    bound = chip_smoke.MARG_BOUNDS[str(dtype).split(".")[-1]]
    rng = np.random.default_rng(5)
    M, C, head = 900, 130, 60
    A = rng.standard_normal((M, C)) * np.exp(rng.uniform(-2, 2, (M, 1)))
    A[rng.random(M) < 0.5] = 0.0
    A[:, [3, 40]] = 0.0
    A[:, 57] = A[:, 22] - 0.5 * A[:, 29]
    leaf = mc.limits(dtype)[3]
    S = float((np.abs(A).T @ np.abs(A)).max())
    infos = []
    for chunk in (M - head, 300, 100):
        parts, want_leaves = [A[:head]], 0
        for r in range(head, M, chunk):
            k = min(r + chunk, M) - r
            parts += [A[r:r + k], np.zeros(((-k) % leaf, C))]
            want_leaves += -(-k // leaf)
        At = torch.as_tensor(np.concatenate(parts), dtype=dtype, device=dev)
        assert mc.leaves(At.shape[0], head)[0] == 1 + want_leaves
        R = mc.marg_qr(At, head=head)
        assert torch.equal(R, mc.marg_qr(At, head=head))
        R64, A64 = R.double(), At.double()
        assert float((R64.T @ R64 - A64.T @ A64).abs().max()) <= bound * S
        assert float(R[[3, 40]].abs().max()) == 0.0 and float(torch.tril(R, -1).abs().max()) == 0.0
        info = R64[20:-1, 20:].T @ R64[20:-1, 20:]
        info[-1, -1] = 0.0  # r0ᵀr0: split with the last row where a kept pivot is rounding
        infos.append(info)
    assert all(float((x - infos[0]).abs().max()) <= bound * S for x in infos[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_marg_depth_into_views_and_at_the_widest_stack(dev, dtype):
    """marg_depth against depth_plain within chip_smoke.MARG_BOUNDS of each
    slot's scale, written into views that start 0, 1, 2 and 3 entries into
    a buffer (chip_smoke.depth_view_check: nothing written outside the view,
    a repeat bit-identical), on relo_layout's windows with 96% of the slots
    anchored at frame 0: one camera at 11 frames and 256 slots, two cameras
    with the extrinsics and td estimated, and one camera at 25 frames (C =
    383, the widest stack marg_qr takes); at each a NaN and an inf depth
    carried as depth_plain carries them (chip_smoke.depth_nonfinite_check);
    at 26 frames (C = 398) marg_depth raises ValueError and counts no
    launch."""
    import dataclasses

    import chip_smoke
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.backend.proj_cuda import proj_rows

    bound = chip_smoke.MARG_BOUNDS[str(dtype).split(".")[-1]]

    def depth_args(W1, F, nc):
        st, grid, cfg, _ = chip_smoke.relo_layout(dev, dtype, W1, F, nc, "front")
        cfg = dataclasses.replace(cfg, estimate_extrinsic=nc > 1, estimate_td=nc > 1)
        grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
        res, J26, w, _ = proj_rows(st, grid0, cfg)
        return res, J26, w, grid0, cfg, nc

    for args in (depth_args(11, 256, 1), depth_args(11, 96, 2), depth_args(25, 64, 1)):
        for offset in range(4):
            err, alone, same, _ = chip_smoke.depth_view_check(args, offset)
            assert err <= bound and alone and same, (args[3].valid.shape, offset, err)
        same_nan, n_nan, err = chip_smoke.depth_nonfinite_check(args)
        assert same_nan and n_nan and err <= bound, (same_nan, n_nan, err)
    wide = depth_args(26, 8, 1)
    before = mc.marg_depth.launches
    with pytest.raises(ValueError):
        mc.marg_depth(*wide)
    assert mc.marg_depth.launches == before


def test_marg_wrappers_reject_what_the_kernels_do_not_take(dev):
    """marg_depth and marg_qr raise on a mistyped, misplaced or strided
    input, a stack wider than the kernel takes and a head beyond its rows;
    no launch is counted."""
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.backend.proj_cuda import proj_rows

    st, grid, *_, cfg = _marg_window(dev, torch.float32, 32)
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res, J26, w, _ = proj_rows(st, grid0, cfg)
    before = (mc.marg_depth.launches, mc.marg_qr.launches)
    bad_depth = [(res.double(), J26, w), (res, J26[..., :25].contiguous(), w),
                 (res, J26, w.t().contiguous().t())]
    for r, j, ww in bad_depth:
        with pytest.raises(ValueError):
            mc.marg_depth(r, j, ww, grid0, cfg, 1)
    with pytest.raises(ValueError):
        mc.marg_depth(res, J26, w, grid0, cfg, 1, out=torch.empty(3, 3, device=dev))
    A = torch.randn(50, 40, device=dev)
    for bad, kw in ((A.half(), {}), (A.t(), {}), (torch.randn(50, 400, device=dev), {}),
                    (A, {"head": 51})):
        with pytest.raises(ValueError):
            mc.marg_qr(bad, **kw)
    assert (mc.marg_depth.launches, mc.marg_qr.launches) == before


def test_marg_programs_graph_matches_eager(dev):
    """marginalize_old_qr and marginalize_second_new_qr as DevicePrograms
    (f32 and f64): each MARGIN_OLD replay counts one marg_depth and one
    marg_qr launch, each SECOND_NEW replay one marg_qr launch, and the
    replays equal the eager functions bit for bit (the kernels have no
    atomics in their arithmetic)."""
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.backend.marginalize import (marginalize_old_qr,
                                                     marginalize_second_new_qr)
    from lfvio_tpu_torch.device import DeviceProgram, collect_launches

    for dtype in (torch.float32, torch.float64):
        args = _marg_window(dev, dtype, 128)
        st, prior, cfg = args[0], args[5], args[7]
        old = lambda s: marginalize_old_qr(s, *args[1:])
        new = lambda s: marginalize_second_new_qr(s, prior, cfg)
        for fn, want in ((old, [1, 1]), (new, [0, 1])):
            prog = DeviceProgram(fn)
            eager = fn(st)
            prog(st)
            collect_launches()
            before = [mc.marg_depth.launches, mc.marg_qr.launches]
            for _ in range(2):
                out = prog(st)
            torch.cuda.synchronize()
            collect_launches()
            assert [mc.marg_depth.launches - before[0], mc.marg_qr.launches - before[1]] == [
                2 * x for x in want]
            for x, y in zip(_leaves(out), _leaves(eager)):
                assert torch.equal(x, y)


def test_device_program_spans(dev):
    """Under a recording profile a DeviceProgram's first call opens
    ``vio::prog.<name>.capture`` and its replay ``.replay``; a later call
    ``.copy_in`` then ``.replay``; the results are the function's. Without
    a profile the calls open nothing and give the same results."""
    from lfvio_tpu_torch.device import DeviceProgram
    from torch.autograd import DeviceType

    def affine(x):
        return x * 2 + 1

    x = torch.arange(8.0, device=dev)
    prog = DeviceProgram(affine, name="affine")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = prog(x).clone()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof2:
        b = prog(x + 1).clone()
        torch.cuda.synchronize()
    c = prog(x + 2).clone()
    names = [[e.name for e in sorted(p.events(), key=lambda e: e.time_range.start)
              if e.device_type == DeviceType.CPU and e.name.startswith("vio::")]
             for p in (prof, prof2)]
    assert names == [["vio::prog.affine.capture", "vio::prog.affine.replay"],
                     ["vio::prog.affine.copy_in", "vio::prog.affine.replay"]]
    assert torch.equal(a, affine(x)) and torch.equal(b, affine(x + 1))
    assert torch.equal(c, affine(x + 2)) and prog.replays == 3
