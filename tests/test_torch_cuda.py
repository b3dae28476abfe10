"""The LK level kernel (lfvio_tpu_torch/csrc/lk_level.cu) on a CUDA card.

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


def _shift_case(dev, H=480, W=640, N=96, dx=2.7, dy=-1.9, seed=0):
    """A smoothed blocky texture, its bilinear shift by (dx, dy), the
    pyramids of both and N points away from the border (4 invalid)."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.random((H // 8, W // 8)), np.ones((8, 8)))
    for ax in (0, 1):  # 5-tap box blur
        img = sum(np.roll(img, s, axis=ax) for s in range(-2, 3)) / 5.0
    img0 = torch.as_tensor(img * 255.0, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    grid = torch.stack([(xx - dx) / (W - 1) * 2 - 1, (yy - dy) / (H - 1) * 2 - 1], -1)
    img1 = torch.nn.functional.grid_sample(
        img0[None, None], grid[None].float(), mode="bilinear", align_corners=True,
        padding_mode="border")[0, 0]
    pts = torch.as_tensor(
        np.stack([rng.uniform(50, W - 50, N), rng.uniform(50, H - 50, N)], -1),
        dtype=torch.float32, device=dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[:4] = False
    return gaussian_pyramid(img0, 3), gaussian_pyramid(img1, 3), pts, valid, (dx, dy)


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


def test_pyramid_matches_plain_and_truth(dev):
    """The whole level loop with the refine pass: five launches, agreement
    with the plain version, and the known shift recovered (median error
    < 0.35 px, tests/test_klt_pallas.py's bound)."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev)
    before = klt_cuda.lk_level.launches
    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    torch.cuda.synchronize()
    assert klt_cuda.lk_level.launches == before + 5
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert (kok == pok).float().mean().item() >= 0.99
    both = kok & pok
    assert both.sum().item() >= len(pts) - 10
    err = (kp[both] - pp[both]).abs().max().item()
    assert err < 0.05
    assert err < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, N=8)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0].double(), pyr1[0].double(), pts.double(),
                          torch.zeros_like(pts).double(), valid)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0], pyr1[0], pts.cpu(), torch.zeros_like(pts), valid)


def test_frontend_on_cuda_runs_through_the_kernel(dev):
    """The port's FrontEnd on the card tracks through the kernel."""
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R), device=dev)
    before = klt_cuda.lk_level.launches
    outs = [fe.process_arrays(world.render(k / 15), k / 15) for k in range(3)]
    assert klt_cuda.lk_level.launches == before + 10
    assert outs[2][4].sum() > 60
