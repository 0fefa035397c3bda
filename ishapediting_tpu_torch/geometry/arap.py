"""As-rigid-as-possible mesh deformation (reference: meshProcess.py:222-236,
Open3D ``deform_as_rigid_as_possible``).

Classic local/global ARAP (Sorkine & Alexa 2007): alternate per-vertex SVD
rotation fits with a global sparse Poisson solve under handle constraints.
Cotangent weights, scipy sparse Cholesky-ish (splu) factorized once.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ishapediting_tpu_torch.geometry.mesh import TriMesh


def _cotangent_weights(mesh: TriMesh) -> sp.csr_matrix:
    v = mesh.vertices
    t = mesh.triangles
    n = len(v)
    ii, jj, ww = [], [], []
    for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        va, vb, vc = v[t[:, a]], v[t[:, b]], v[t[:, c]]
        # cot of angle at vertex c (opposite edge a-b)
        u = va - vc
        w = vb - vc
        cos = np.einsum("ij,ij->i", u, w)
        sin = np.linalg.norm(np.cross(u, w), axis=1)
        cot = cos / np.maximum(sin, 1e-12)
        ii.extend([t[:, a], t[:, b]])
        jj.extend([t[:, b], t[:, a]])
        ww.extend([0.5 * cot, 0.5 * cot])
    W = sp.csr_matrix(
        (np.concatenate(ww), (np.concatenate(ii), np.concatenate(jj))),
        shape=(n, n),
    )
    W.data = np.maximum(W.data, 1e-6)  # clamp negative cotangents for stability
    return W


def arap_deform(
    mesh: TriMesh,
    constraint_ids: Sequence[int],
    constraint_pos: np.ndarray,
    max_iter: int = 50,
) -> TriMesh:
    """Deform so that ``constraint_ids`` vertices land on ``constraint_pos``;
    all other vertices move as-rigidly-as-possible.

    Mirrors the reference's call shape (static + handle ids with target
    positions, meshProcess.py:228-235).
    """
    v0 = mesh.vertices.copy()
    n = len(v0)
    constraint_ids = np.asarray(list(constraint_ids), np.int64)
    constraint_pos = np.asarray(constraint_pos, np.float64).reshape(-1, 3)

    W = _cotangent_weights(mesh)
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W  # graph Laplacian

    free = np.setdiff1d(np.arange(n), constraint_ids)
    L_ff = L[free][:, free].tocsc()
    L_fc = L[free][:, constraint_ids]
    solver = spla.splu(L_ff)

    Wcoo = W.tocoo()
    ei, ej, ew = Wcoo.row, Wcoo.col, Wcoo.data
    d0 = v0[ei] - v0[ej]  # rest edges

    p = v0.copy()
    p[constraint_ids] = constraint_pos
    for _ in range(max_iter):
        # local: per-vertex rotation via SVD of weighted covariance
        d = p[ei] - p[ej]
        # accumulate per-vertex 3x3 covariances S_i = sum_j w_ij d0_ij d_ij^T
        S = np.zeros((n, 3, 3))
        contrib = ew[:, None, None] * (d0[:, :, None] * d[:, None, :])
        np.add.at(S, ei, contrib)
        U, _, Vh = np.linalg.svd(S)
        # R_i = V U^T (det-positive branch of the orthogonal Procrustes fit)
        R = np.matmul(np.transpose(Vh, (0, 2, 1)), np.transpose(U, (0, 2, 1)))
        flip = np.linalg.det(R) < 0
        if flip.any():
            Vh_f = Vh[flip].copy()
            Vh_f[:, -1, :] *= -1  # flip the last right-singular vector
            R[flip] = np.matmul(
                np.transpose(Vh_f, (0, 2, 1)), np.transpose(U[flip], (0, 2, 1))
            )

        # global: solve L p = b with b_i = sum_j w_ij/2 (R_i + R_j) d0_ij
        Rsum = R[ei] + R[ej]
        rhs_e = 0.5 * ew[:, None] * np.einsum("nij,nj->ni", Rsum, d0)
        b = np.zeros((n, 3))
        np.add.at(b, ei, rhs_e)
        b_f = b[free] - L_fc @ constraint_pos
        p_new = p.copy()
        p_new[free] = np.column_stack(
            [solver.solve(b_f[:, k]) for k in range(3)]
        )
        p_new[constraint_ids] = constraint_pos
        if np.abs(p_new - p).max() < 1e-7:
            p = p_new
            break
        p = p_new

    return TriMesh(p, mesh.triangles.copy())
