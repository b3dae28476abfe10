"""Spherical epipolar RANSAC on unit bearing vectors, batched.

Port of ``lfvio_tpu.frontend.ransac.spherical_ransac_e`` (the reference's
myfindFundamentalMat / compute_E_21 / check_inliers,
feature_tracker.cpp:186-327): 8-point essential matrices on bearings for
100 hypotheses at once (batched 9x9 eigh: ``geom/eigh_cuda.py``'s kernel
on the card, so a frame's dispatch never waits for it), symmetric cosine
residual with threshold sin(0.5°), best-score selection and a refit on the
inliers.

The random draws are an argument: the caller makes the [n_hyp, N] uniforms
(the FrontEnd from its own ``torch.Generator``), so a test can hand in the
JAX package's draws.
"""

from __future__ import annotations

import torch

from ..geom.eigh_cuda import sym_eig

COS_THR = 0.00872653549837  # sin(0.5 deg), reference feature_tracker.cpp:226
N_HYPOTHESES = 100  # reference max_num_iter (feature_tracker.cpp:290)


def _constraint_rows(b1, b2):
    """Rows with row·vec(E) = b2ᵀ E b1, E row-major."""
    return (b2[..., :, None] * b1[..., None, :]).reshape(*b1.shape[:-1], 9)


def _solve_E(A, weights=None):
    """Least-squares essential matrix from constraint rows A [..., n, 9]:
    smallest eigenvector of AᵀA, projected to rank 2. Defined up to sign.

    The projection is E (I − v₃v₃ᵀ), v₃ the smallest eigenvector of EᵀE:
    with E = U diag(s₁, s₂, s₃) Vᵀ that is exactly U diag(s₁, s₂, 0) Vᵀ, the
    JAX package's svd form, from the same eigensolver."""
    if weights is not None:
        A = A * weights[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    _, V = sym_eig(AtA)
    E = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    _, W = sym_eig(E.transpose(-1, -2) @ E)
    v3 = W[..., :, 0]
    return E - (E @ v3[..., :, None]) * v3[..., None, :]


def _score(E, b1, b2, valid):
    """check_inliers: a match is an inlier iff both directed residuals pass;
    the score accumulates (thr - r2)² when r2 passes plus (thr - r1)² when
    both pass."""
    Eb1 = torch.einsum("...ij,nj->...ni", E, b1)
    Etb2 = torch.einsum("...ji,nj->...ni", E, b2)
    r2 = torch.abs(torch.einsum("...ni,ni->...n", Eb1, b2)) / torch.clamp(
        torch.linalg.norm(Eb1, dim=-1), min=1e-12
    )
    r1 = torch.abs(torch.einsum("...ni,ni->...n", Etb2, b1)) / torch.clamp(
        torch.linalg.norm(Etb2, dim=-1), min=1e-12
    )
    pass2 = (r2 <= COS_THR) & valid
    pass1 = (r1 <= COS_THR) & valid
    inlier = pass1 & pass2
    score = torch.sum(
        torch.where(pass2, (COS_THR - r2) ** 2, 0.0)
        + torch.where(inlier, (COS_THR - r1) ** 2, 0.0),
        dim=-1,
    )
    return inlier, score


def spherical_ransac_e(uniforms, b1, b2, valid):
    """RANSAC essential matrix between bearing sets b1, b2 [N, 3].

    uniforms: [n_hyp, N] draws in [0, 1) choosing each hypothesis's minimal
    set (the 8 smallest keys among valid entries).
    Returns (E [3,3], inliers [N] bool); invalid entries are never inliers.
    """
    keys = uniforms + (~valid)[None, :].to(uniforms.dtype) * 10.0
    order = torch.argsort(keys, dim=-1)[:, :8]  # [n_hyp, 8]
    E_hyp = _solve_E(_constraint_rows(b1[order], b2[order]))
    inl_hyp, score_hyp = _score(E_hyp, b1, b2, valid)
    # index_select, not [best]: indexing with a 0-dim tensor reads it on the host.
    best = torch.argmax(score_hyp).reshape(1)
    best_inl = inl_hyp.index_select(0, best)[0]

    # Refit on the best hypothesis's inliers + rescore
    # (feature_tracker.cpp:311-326); keep the hypothesis if it collapses.
    E_fit = _solve_E(_constraint_rows(b1, b2), weights=best_inl.to(b1.dtype))
    inliers, _ = _score(E_fit, b1, b2, valid)
    ok = torch.sum(inliers) >= 8
    return (torch.where(ok, E_fit, E_hyp.index_select(0, best)[0]),
            torch.where(ok, inliers, best_inl))
