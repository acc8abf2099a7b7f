"""Constant-folding scalar matrix math for forward kinematics.

Port of `vamp_mvt_tpu/ops/smat.py`.  Entries of a rotation/translation are
either Python floats (constants, folded in float64) or float32 tensors of a
common batch shape.  Products and sums fold constants as they are built, so a
chain of URDF origin rotations and joint rotations emits a minimal
elementwise program; terms are summed in index order (`dot_terms`), the
order the CUDA kernel follows too.
"""

from __future__ import annotations

import numpy as np


def is_const(e) -> bool:
    return isinstance(e, (int, float))


def _mul(a, b):
    if is_const(a) and is_const(b):
        return float(a) * float(b)
    if is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return -b
        return a * b
    if is_const(b):
        return _mul(b, a)
    return a * b


def _add(a, b):
    if is_const(a) and is_const(b):
        return float(a) + float(b)
    if is_const(a) and a == 0.0:
        return b
    if is_const(b) and b == 0.0:
        return a
    return a + b


def dot_terms(terms):
    """Sum of products, folding constants and dropping zero terms."""
    out = 0.0
    for a, b in terms:
        out = _add(out, _mul(a, b))
    return out


def matmul(A, B):
    """(3,3) @ (3,3) with mixed const/tensor entries."""
    return [
        [dot_terms((A[i][k], B[k][j]) for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def matvec(A, v):
    return [dot_terms((A[i][k], v[k]) for k in range(3)) for i in range(3)]


def vecadd(a, b):
    return [_add(a[i], b[i]) for i in range(3)]


def vecscale(v, s):
    return [_mul(s, v[i]) for i in range(3)]


def const_mat(m: np.ndarray):
    return [[float(m[i, j]) for j in range(3)] for i in range(3)]


def const_vec(v: np.ndarray):
    return [float(v[i]) for i in range(3)]


def identity():
    return [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]


def axis_rotation_terms(axis: np.ndarray):
    """Rodrigues coefficients (A, I - A, K) of R = A + (I - A) c + K s for a
    constant unit axis, A = axis axis^T, K = [axis]_x (float64)."""
    a = np.asarray(axis, dtype=np.float64)
    A = np.outer(a, a)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return A, np.eye(3) - A, K


def axis_rotation(axis: np.ndarray, c, s):
    """Rotation about a constant unit axis with tensor cos/sin; entries with
    zero coefficients fold to constants (a z rotation has 4 tensor entries)."""
    A, IA, K = axis_rotation_terms(axis)
    out = []
    for i in range(3):
        row = []
        for j in range(3):
            e = float(A[i, j])
            e = _add(e, _mul(float(IA[i, j]), c))
            e = _add(e, _mul(float(K[i, j]), s))
            row.append(e)
        out.append(row)
    return out
