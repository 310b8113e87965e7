"""Batched linear algebra of the beamforming design (counterpart of
``haghighatshoarmuir2024_tpu/ops/linalg.py:14-126``; reference:
micloc/beamformer.py:157-190,
micloc/snn_beamformer.py:181-203, 372-422).

Every routine takes a batch of matrices in its leading dims (the DoA grid).
``torch.linalg.eigh`` stands for XLA's eigh: eigenvalues ascending, each
eigenvector's sign or phase whatever the solver gives.
"""
from __future__ import annotations

import torch


def top_eigvec_psd(C: torch.Tensor) -> torch.Tensor:
    """Dominant eigenvector of a PSD (Hermitian) matrix: ``U[:, 0]`` of
    ``np.linalg.svd(C)`` up to a unit phase (micloc/beamformer.py:160-161)."""
    return torch.linalg.eigh(C)[1][..., :, -1]


def svd_singvals_psd(C: torch.Tensor) -> torch.Tensor:
    """Singular values of a PSD matrix in descending order (eigvalsh
    reversed)."""
    return torch.linalg.eigvalsh(C).flip(-1)


def dc_removed_sing_vec(C: torch.Tensor, iters: int = 80) -> torch.Tensor:
    """Dominant-eigenvalue direction of PSD ``C`` constrained orthogonal to the
    all-ones vector (JAX ``linalg.py:30-77``;
    micloc/snn_beamformer.py:372-422).

    With C = U diag(D) U^T (D descending) and theta = U^T 1, ``iters``
    bisections find the root u* of ``sum_i theta_i^2 / (D_i - u) = 0`` on
    (D[1], D[0]); the vector is U (theta / (D - u*)), normalized.  Each term
    ``U_i theta_i`` is the same for either sign of ``U_i``, so the result
    does not depend on the solver's signs.

    Unipolar spikes and positive neuron kernels give the covariance a
    dominant DC component; this removes it.
    """
    w, U = torch.linalg.eigh(C)
    D = w.flip(-1)
    U = U.flip(-1)
    theta = U.sum(dim=-2)  # U^T 1
    u_min, u_max = D[..., 1], D[..., 0]
    for _ in range(iters):
        u_mid = (u_min + u_max) / 2
        neg = (theta**2 / (D - u_mid[..., None])).sum(dim=-1) < 0.0
        u_min, u_max = torch.where(neg, u_mid, u_min), torch.where(neg, u_max, u_mid)
    root = (u_min + u_max) / 2.0
    # Tied top eigenvalues (D0 == D1, real for float32-exact covariances of
    # structured spike trains) leave the bracket empty: the root lands on the
    # eigenvalue and theta / (D - root) is 0/0.  That NaN once zeroed whole
    # unipolar designs.  The denominator is clamped at a scale-relative
    # epsilon, which puts the weight on the tied leading directions, the
    # constrained maximizer there (JAX ``linalg.py:64-75``).
    denom = D - root[..., None]
    tiny = 1e-7 * torch.clamp(D[..., :1].abs(), min=1e-30)
    denom = torch.where(denom.abs() < tiny, torch.where(denom < 0, -tiny, tiny), denom)
    vec = (U * (theta / denom)[..., None, :]).sum(dim=-1)
    return vec / torch.linalg.norm(vec, dim=-1, keepdim=True)


def fold_complex_cov(C: torch.Tensor) -> torch.Tensor:
    """Fold a real 2M x 2M covariance of the stacked [real || imag] signal into
    the M x M complex Hermitian form of bipolar SNN beamforming
    (micloc/snn_beamformer.py:188-199):

        C_diag = (C[:M,:M] + C[M:,M:]) / 2
        C_off  = (C[:M,M:] + C[M:,:M].T) / 2
        C_comp = C_diag + 1j * C_off
    """
    m = C.shape[-1] // 2
    C_diag = (C[..., :m, :m] + C[..., m:, m:]) / 2
    C_off = (C[..., :m, m:] + C[..., m:, :m].transpose(-1, -2)) / 2
    return torch.complex(C_diag, C_off)


def unfold_complex_vec(u: torch.Tensor) -> torch.Tensor:
    """Complex M-vector → real 2M beamforming vector [Re(u) || Im(u)]
    (micloc/snn_beamformer.py:203)."""
    return torch.cat([u.real, u.imag], dim=-1)


def generalized_top_eigvec(C: torch.Tensor, B: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit-norm top eigenvector of the pencil ``C v = λ B v`` by Cholesky
    whitening (JAX ``linalg.py:80-105``; micloc/beamformer.py:165-190 takes
    the last column of ``scipy.linalg.eigh(C, B)``): ``B = L Lᴴ``,
    ``M = L⁻¹ C L⁻ᴴ`` by two triangular solves, symmetrized, its top
    eigenvector ``u`` by ``eigh``, back-substituted ``v = L⁻ᴴ u``.  B must
    be positive definite (the reference loads its diagonal); ``eps`` adds
    ``eps·I`` to it.  Batched over leading dims; the phase of ``v`` is the
    solver's."""
    if eps:
        B = B + eps * torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    L = torch.linalg.cholesky(B)
    Linv_C = torch.linalg.solve_triangular(L, C, upper=False)
    M = torch.linalg.solve_triangular(L, Linv_C.mH, upper=False).mH
    M = (M + M.mH) / 2
    u = torch.linalg.eigh(M)[1][..., :, -1]
    v = torch.linalg.solve_triangular(L.mH, u[..., None], upper=True)[..., 0]
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
