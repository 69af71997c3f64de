"""Nister 5-point essential-matrix solver with fixed shapes (port of
``libviso_tpu/geometry/five_point.py``).

1. The 4-dim null space of the 5x9 epipolar system (batched SVD) gives
   E(x, y, z) = x E1 + y E2 + z E3 + E4.
2. The ten cubic constraints (det E = 0, 2 E E'E - tr(E E') E = 0) over 20
   monomials: their (10, 20) coefficient matrix by exact interpolation at
   20 fixed nodes times a precomputed inverse Vandermonde.
3. Gauss-Jordan as one batched 10x10 solve; Nister's three cancelling row
   pairs give the 3x3 polynomial matrix B(z) and det B(z), degree 10.
4. Real roots by a sign-change scan over a tangent-spaced grid, bisection
   and Newton, plus the deepest local minima of |p| for near-double roots.
5. Each root back-substituted to (x, y), polished by damped Gauss-Newton on
   the raw constraints, with 8 fixed extra starting points; up to 22
   candidates a sample, each checked against the constraints.

A sample's candidates do not depend on the batch it is solved in: small
products and sums are elementwise products added by ``_tree_sum``, the
3x3 determinant is written out, and a lone sample's SVD and solve run as
a batch of two copies (a library picks another algorithm for one matrix
than for a batch, which rounds otherwise).

Monomial order (Nister 2004):
  m = [x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y]
  n = [x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1]
"""

from __future__ import annotations

import numpy as np
import torch

from libviso_torch.geometry.mvg import e2h
from libviso_torch.ops.topk import first_argmax, topk_sorted
from libviso_torch.solvers.gauss_newton import _tree_sum

_EXPONENTS = np.array([
    # m (eliminated) monomials
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    # n (retained) monomials
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
], dtype=np.int64)


def _make_nodes_and_vinv():
    """The 20 interpolation nodes (the best-conditioned of 200 random sets
    from a fixed seed) and their inverse Vandermonde, in float64 on the
    host: the JAX package's nodes, value for value."""
    rng = np.random.default_rng(12345)
    best = None
    for _ in range(200):
        nodes = rng.uniform(-1.0, 1.0, (20, 3))
        V = np.prod(nodes[:, None, :] ** _EXPONENTS[None, :, :], axis=-1)
        c = np.linalg.cond(V)
        if best is None or c < best[0]:
            best = (c, nodes, V)
    _, nodes, V = best
    return nodes, np.linalg.inv(V)


_NODES, _VINV = _make_nodes_and_vinv()

# Gauss-Newton starting points of the auxiliary polish basins
_EXTRA_STARTS = np.array([
    (0.0, 0.0, 0.0), (0.5, 0.3, 0.2), (-0.5, 0.3, -0.2),
    (1.0, -1.0, 0.5), (-1.0, 1.0, -0.5), (2.0, 2.0, -1.0),
    (3.0, -3.0, 1.0), (-3.0, 3.0, -1.0),
], dtype=np.float64)


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _mm(A, B):
    """A @ B for small (..., m, k) x (..., k, n) matrices, batch-invariant."""
    return _tree_sum(A[..., :, :, None] * B[..., None, :, :], -2)


def _norm(x, dims: int = 1):
    """Euclidean norm over the last ``dims`` axes, batch-invariant."""
    return torch.sqrt(_tree_sum((x * x).flatten(-dims), -1))


def _as_batch(fn, *xs, core: int = 2):
    """fn over tensors whose leading axes (all but the last ``core``) hold
    a batch; a batch of one runs as a batch of two copies, so that it
    takes the library's batched path as a larger batch does."""
    if xs[0].shape[:-core].numel() != 1:
        return fn(*xs)
    out = fn(*(torch.cat([x, x]) if x.dim() > core else
               torch.stack([x, x]) for x in xs))
    if isinstance(out, tuple):
        return type(out)(*(o[:1] if xs[0].dim() > core else o[0]
                           for o in out))
    return out[:1] if xs[0].dim() > core else out[0]


def _trace(A):
    return (A[..., 0, 0] + A[..., 1, 1]) + A[..., 2, 2]


def _det3(E):
    """Determinant of 3x3 matrices by cofactors along row 0."""
    e = [[E[..., i, j] for j in range(3)] for i in range(3)]
    return (e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
            - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
            + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0]))


def _constraints(E):
    """The 10 Nister constraint values of 3x3 matrices (batched):
    c0 = det(E); c1..c9 = vec(2 E E' E - tr(E E') E) row-major."""
    EEt = _mm(E, E.transpose(-1, -2))
    C = 2.0 * _mm(EEt, E) - _trace(EEt)[..., None, None] * E
    return torch.cat([_det3(E)[..., None], C.reshape(*C.shape[:-2], 9)],
                     dim=-1)


def _combine(coeffs, basis):
    """sum_a coeffs[..., k, a] basis[..., a, :, :] -> (..., K, 3, 3)."""
    return _tree_sum(coeffs[..., :, :, None, None]
                     * basis[..., None, :, :, :], -3)


def _coefficient_matrix(basis):
    """(..., 10, 20) polynomial coefficients of the constraints of the
    null-space basis (..., 4, 3, 3) (E1, E2, E3, E4)."""
    nodes = _const(_NODES, basis)                               # (20, 3)
    coeffs = torch.cat([nodes, torch.ones_like(nodes[:, :1])], dim=-1)
    vals = _constraints(_combine(coeffs, basis))                # (..., 20, 10)
    # row r of M solves V @ M_r = vals[:, r]  ->  M = (Vinv @ vals)'
    return _mm(_const(_VINV, basis), vals).transpose(-1, -2)


def _b_polys(C):
    """Polynomial entries of B(z) from the reduced system C (..., 10, 10)
    (m_r + sum_j C[r, j] n_j = 0): (Bx, By, B1) of shapes (..., 3, 4),
    (..., 3, 4), (..., 3, 5), ascending powers of z."""
    bx, by, b1 = [], [], []
    for r1, r2 in ((4, 5), (6, 7), (8, 9)):
        c1 = C[..., r1, :]
        c2 = C[..., r2, :]
        # sum_j (z c2[j] - c1[j]) n_j = 0
        bx.append(torch.stack([-c1[..., 2], c2[..., 2] - c1[..., 1],
                               c2[..., 1] - c1[..., 0], c2[..., 0]], dim=-1))
        by.append(torch.stack([-c1[..., 5], c2[..., 5] - c1[..., 4],
                               c2[..., 4] - c1[..., 3], c2[..., 3]], dim=-1))
        b1.append(torch.stack([-c1[..., 9], c2[..., 9] - c1[..., 8],
                               c2[..., 8] - c1[..., 7],
                               c2[..., 7] - c1[..., 6], c2[..., 6]], dim=-1))
    return (torch.stack(bx, dim=-2), torch.stack(by, dim=-2),
            torch.stack(b1, dim=-2))


def _polymul(a, b):
    """Coefficient convolution of ascending-power polynomials (batched)."""
    la, lb = a.shape[-1], b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = a.new_zeros(*lead, la + lb - 1)
    for i in range(la):
        out[..., i:i + lb] = out[..., i:i + lb] + a[..., i:i + 1] * b
    return out


def _det_poly(Bx, By, B1):
    """Degree-10 det B(z) coefficients (..., 11), ascending powers:
    cofactor expansion along row 0."""
    x0, y0, c0 = Bx[..., 0, :], By[..., 0, :], B1[..., 0, :]
    x1, y1, c1 = Bx[..., 1, :], By[..., 1, :], B1[..., 1, :]
    x2, y2, c2 = Bx[..., 2, :], By[..., 2, :], B1[..., 2, :]
    m00 = _polymul(y1, c2) - _polymul(y2, c1)   # deg 7 (8)
    m01 = _polymul(x1, c2) - _polymul(x2, c1)   # deg 7 (8)
    m02 = _polymul(x1, y2) - _polymul(x2, y1)   # deg 6 (7)
    det = _polymul(x0, m00) - _polymul(y0, m01)           # deg 10 (11)
    c = _polymul(c0, m02)
    return det + torch.nn.functional.pad(c, (0, det.shape[-1] - c.shape[-1]))


def _polyval(coeffs, z):
    """Horner evaluation, ascending coefficients (..., L) at z (..., K)."""
    acc = torch.zeros_like(z) + coeffs[..., -1:]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        acc = acc * z + coeffs[..., i:i + 1]
    return acc


def real_roots_deg10(coeffs, grid_size: int = 512, bisect_iters: int = 12,
                     newton_iters: int = 4, max_bound: float = 100.0):
    """Up to 10 real roots of degree-10 polynomials (..., 11) (batched,
    fixed shape): sign changes over a tangent-spaced grid on [-R, R] (R the
    Cauchy bound, clamped) seed bisection brackets, then Newton; the 4
    deepest interior local minima of |p| are added as candidates for
    near-double roots.

    Returns (roots (..., 14), valid (..., 14)): 10 sign-change slots, then
    4 local-minimum slots.
    """
    dtype = coeffs.dtype
    scale = coeffs.abs().amax(-1, keepdim=True)
    c = coeffs / torch.clamp(scale, min=1e-30)
    lead = c[..., -1]
    bound = 1.0 + c[..., :-1].abs().amax(-1) / torch.clamp(lead.abs(),
                                                           min=1e-6)
    bound = torch.clamp(bound, max=max_bound)

    k = torch.arange(grid_size, dtype=dtype, device=c.device)
    tmax = torch.arctan(bound)
    theta = 2.0 * k / (grid_size - 1) - 1.0
    z = torch.tan(tmax[..., None] * theta)                      # (..., K)
    p = _polyval(c, z)
    sign_change = (p[..., :-1] * p[..., 1:]) < 0                # (..., K-1)

    # the first 10 bracket indices (ascending; then the remaining slots in
    # ascending order, masked by `valid`), lax.top_k's order
    idxf = torch.arange(grid_size - 1, dtype=dtype, device=c.device)
    score = torch.where(sign_change, -idxf, float("-inf"))
    _, top = topk_sorted(score, 10)
    valid = torch.gather(sign_change, -1, top)

    lo = torch.gather(z, -1, top)
    hi = torch.gather(z, -1, top + 1)
    plo = _polyval(c, lo)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        pm = _polyval(c, mid)
        left = (plo * pm) <= 0
        lo, hi, plo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, plo, pm))
    root = 0.5 * (lo + hi)

    dc = c[..., 1:] * torch.arange(1, c.shape[-1], dtype=dtype,
                                   device=c.device)
    for _ in range(newton_iters):
        f = _polyval(c, root)
        df = _polyval(dc, root)
        step = f / torch.where(df.abs() > 1e-20, df, float("inf"))
        root = torch.where(step.abs() < 1.0, root - step, root)

    ap = p.abs()
    interior = (ap[..., 1:-1] <= ap[..., :-2]) & (ap[..., 1:-1]
                                                  <= ap[..., 2:])
    lm_score = torch.where(interior, -ap[..., 1:-1], float("-inf"))
    _, lm_top = topk_sorted(lm_score, 4)
    lm_root = torch.gather(z[..., 1:-1], -1, lm_top)
    lm_valid = torch.gather(interior, -1, lm_top)
    return (torch.cat([root, lm_root], dim=-1),
            torch.cat([valid, lm_valid], dim=-1))


def svd_null_basis(Q):
    """The default null-space basis (..., 4, 3, 3) of Q (..., 5, 9): rows
    5-8 of the full Vh, reversed, so that E4 (the affine term, coefficient
    fixed at 1) is the largest-sigma of the four null vectors (the JAX
    package's order)."""
    vh = _as_batch(lambda q: torch.linalg.svd(q, full_matrices=True).Vh, Q)
    return vh[..., 5:9, :].reshape(*Q.shape[:-2], 4, 3, 3).flip(-3)


def five_point_E(x1, x2, null_basis=None):
    """Essential-matrix candidates from exactly 5 normalized
    correspondences x1, x2 (..., 5, 2), x2' E x1 = 0.

    ``null_basis``: optional callable Q (..., 5, 9) -> (..., 4, 3, 3), the
    null-space basis E1..E4; ``svd_null_basis`` by default.  The basis of
    a 4-dim null space is not unique, so two SVD implementations give the
    same candidates in different bases (a test seam: the parity tests pass
    the JAX package's).

    Returns E (..., 22, 3, 3) Frobenius-normalized candidates (10
    sign-change root slots, 4 local-minimum slots, 8 auxiliary GN basins)
    and valid (..., 22) bool, the slots whose candidate satisfies the
    constraints.
    """
    Q = (e2h(x2)[..., :, None] * e2h(x1)[..., None, :]).reshape(
        *x1.shape[:-1], 9)                                      # (..., 5, 9)
    basis = (null_basis or svd_null_basis)(Q)

    M = _coefficient_matrix(basis)                              # (..., 10, 20)
    M1 = M[..., :, :10]
    M2 = M[..., :, 10:]
    # guard singular leading blocks (degenerate samples)
    gj_ok = _as_batch(torch.linalg.det, M1).abs() > 1e-30
    eye10 = torch.eye(10, dtype=M.dtype, device=M.device)
    M1_safe = torch.where(gj_ok[..., None, None], M1, eye10)
    C = _as_batch(lambda a, b: torch.linalg.solve_ex(a, b).result,
                  M1_safe, M2)                                  # (..., 10, 10)

    Bx, By, B1 = _b_polys(C)
    z, z_valid = real_roots_deg10(_det_poly(Bx, By, B1))        # (..., 14)

    # back-substitute each root slot: B(z) [x, y, 1]' = 0
    def eval_rows(P):
        zz = z[..., :, None]                                    # (..., K, 1)
        out = torch.zeros(*z.shape, 3, dtype=P.dtype, device=P.device) \
            + P[..., None, :, -1]
        for i in range(P.shape[-1] - 2, -1, -1):
            out = out * zz + P[..., None, :, i]
        return out                                              # (..., K, 3)

    B = torch.stack([eval_rows(Bx), eval_rows(By), eval_rows(B1)], dim=-1)
    # null vector of B: the largest cross product of two rows
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)  # (.., K, 3, 3)
    norms = _norm(cands)
    pickc = first_argmax(norms)
    v = torch.take_along_dim(cands, pickc[..., None, None], dim=-2)[..., 0, :]
    w = v[..., 2]
    w_ok = w.abs() > 1e-12
    w_safe = torch.where(w_ok, w, 1.0)
    xy = v[..., :2] / w_safe[..., None]
    xyz = torch.cat([xy, z[..., None]], dim=-1)                 # (..., 14, 3)
    root_valid = z_valid & w_ok & gj_ok[..., None]

    # root slots start near a solution and converge in a few steps; the
    # auxiliary basins start far away and get the larger budget
    extra = _const(_EXTRA_STARTS, xyz).expand(*xyz.shape[:-2],
                                             *_EXTRA_STARTS.shape)
    xyz = torch.cat([_polish_xyz(basis, xyz, iters=3),
                     _polish_xyz(basis, extra, iters=8)], dim=-2)

    coeff = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    E = _combine(coeff, basis)                          # (..., 22, 3, 3)
    E = E / torch.clamp(_norm(E, 2), min=1e-30)[..., None, None]
    res = _norm(_constraints(E))                                # (..., 22)
    n_extra = _EXTRA_STARTS.shape[0]
    slot_valid = torch.cat(
        [root_valid, gj_ok[..., None].expand(*root_valid.shape[:-1],
                                             n_extra)], dim=-1)
    return E, slot_valid & (res < 1e-3)


def _polish_residual(c3, basis, jacobian: bool = True):
    """Constraints of E(c3) / |E(c3)| for candidates c3 (..., 3) against
    bases (..., 4, 3, 3), and with ``jacobian`` their (..., 10, 3)
    Jacobian in c3, written out (det through the cofactor matrix, so a
    singular E keeps a finite derivative)."""
    coeff4 = torch.cat([c3, torch.ones_like(c3[..., :1])], dim=-1)
    E_raw = _combine(coeff4[..., None, :], basis)[..., 0, :, :]
    nrm = torch.clamp(_norm(E_raw, 2), min=1e-30)
    E = E_raw / nrm[..., None, None]
    r = _constraints(E)
    if not jacobian:
        return r, None
    rows = E.unbind(-2)
    cof = torch.stack([torch.linalg.cross(rows[1], rows[2]),
                       torch.linalg.cross(rows[2], rows[0]),
                       torch.linalg.cross(rows[0], rows[1])], dim=-2)
    Et = E.transpose(-1, -2)
    EEt = _mm(E, Et)
    EtE = _mm(Et, E)
    tr = _trace(EEt)
    cols = []
    for a in range(3):
        Ea = basis[..., a, :, :]
        dE = (Ea - E * _tree_sum((E * Ea).flatten(-2), -1)[..., None, None]
              ) / nrm[..., None, None]
        ddet = _tree_sum((cof * dE).flatten(-2), -1)
        dC = (2.0 * (_mm(dE, EtE) + _mm(_mm(E, dE.transpose(-1, -2)), E)
                     + _mm(EEt, dE))
              - 2.0 * _tree_sum((E * dE).flatten(-2), -1)[..., None, None]
              * E - tr[..., None, None] * dE)
        cols.append(torch.cat([ddet[..., None],
                               dC.reshape(*dC.shape[:-2], 9)], dim=-1))
    return r, torch.stack(cols, dim=-1)


def _polish_xyz(basis, xyz, iters: int = 4, damping: float = 1e-8):
    """Gauss-Newton refinement of null-space coordinates xyz (..., K, 3) on
    the scale-normalized constraints of the bases (..., 4, 3, 3); a step is
    kept only where the squared residual fell."""
    b = basis[..., None, :, :, :].expand(*xyz.shape[:-1], 4, 3, 3)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        r, J = _polish_residual(xyz, b)
        Jt = J.transpose(-1, -2)
        A = _mm(Jt, J) + damping * eye
        g = _mm(Jt, r[..., None])
        d = _as_batch(lambda a, v: torch.linalg.solve_ex(a, v).result,
                      A, g)[..., 0]
        c_new = xyz - d
        r_new, _ = _polish_residual(c_new, b, jacobian=False)
        better = _tree_sum(r_new ** 2, -1) < _tree_sum(r ** 2, -1)
        xyz = torch.where(better[..., None], c_new, xyz)
    return xyz
