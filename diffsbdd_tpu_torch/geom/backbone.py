"""Protein backbone frames <-> quaternions (numpy only).

The rigid transform taking the canonical backbone triangle (CA at the origin,
N on the +x axis, C in the upper xy-plane) to its global pose, and idealized
backbone coordinates rebuilt from (CA, quaternion) pairs.  The rotation is
built by Gram-Schmidt on the (N-CA, C-CA) pair.
"""
from __future__ import annotations

import numpy as np

from diffsbdd_tpu_torch.constants import CA_C_DIST, N_CA_C_ANGLE, N_CA_DIST


def _normalize(v, axis=-1, eps=1e-12):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), eps)


def get_bb_transform(n_xyz, ca_xyz, c_xyz):
    """(N, CA, C) coordinates -> (quaternion (n,4), translation (n,3)).

    The rotation R maps canonical-frame coordinates to global coordinates:
    x_global = R @ x_canonical + CA.
    """
    translation = np.asarray(ca_xyz, np.float64)
    n_rel = np.asarray(n_xyz, np.float64) - translation
    c_rel = np.asarray(c_xyz, np.float64) - translation

    e1 = _normalize(n_rel)                              # +x: CA -> N
    c_perp = c_rel - np.sum(c_rel * e1, -1, keepdims=True) * e1
    e2 = _normalize(c_perp)                             # +y: C above x-axis
    e3 = np.cross(e1, e2)                               # +z: right-handed
    rot = np.stack([e1, e2, e3], axis=-1)               # columns = basis
    return rotation_matrix_to_quaternion(rot), translation


def get_bb_coords_from_transform(ca_coords, quaternion):
    """(CA, quaternion) -> idealized backbone coords (n*3, 3) + atom types.

    Order per residue is [N, CA, C] with literature bond geometry
    (constants.N_CA_DIST/CA_C_DIST/N_CA_C_ANGLE).
    """
    ca_coords = np.asarray(ca_coords, np.float64)
    rot = quaternion_to_rotation_matrix(np.asarray(quaternion, np.float64))
    canonical = np.array([
        [N_CA_DIST, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [CA_C_DIST * np.cos(N_CA_C_ANGLE), CA_C_DIST * np.sin(N_CA_C_ANGLE),
         0.0],
    ])
    # (n, 3atoms, 3) = R @ canonical^T, then translate
    bb = np.einsum("nij,aj->nai", rot, canonical) + ca_coords[:, None, :]
    bb_atom_types = [t for _ in range(len(ca_coords)) for t in ("N", "C", "C")]
    return bb.reshape(-1, 3), bb_atom_types


def quaternion_to_rotation_matrix(q):
    """(n, 4) wxyz quaternions -> (n, 3, 3) rotation matrices."""
    q = np.asarray(q, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], 1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], 1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], 1),
    ], axis=1)


def rotation_matrix_to_quaternion(rot):
    """(n, 3, 3) rotation matrices -> (n, 4) wxyz quaternions (w >= 0).

    Shepperd's method: per matrix, build the quaternion from the largest of
    {trace, m00, m11, m22}.  The naive copysign-on-antisymmetric-differences
    shortcut loses the relative signs of (x, y, z) for 180-degree rotations
    (w = 0 makes every difference zero), silently reflecting the axis."""
    rot = np.asarray(rot, np.float64)
    m00, m01, m02 = rot[:, 0, 0], rot[:, 0, 1], rot[:, 0, 2]
    m10, m11, m12 = rot[:, 1, 0], rot[:, 1, 1], rot[:, 1, 2]
    m20, m21, m22 = rot[:, 2, 0], rot[:, 2, 1], rot[:, 2, 2]
    t = m00 + m11 + m22

    def safe(v):
        return 2.0 * np.sqrt(np.maximum(v, 1e-12))

    s0 = safe(1.0 + t)
    q0 = np.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                   (m10 - m01) / s0], 1)
    s1 = safe(1.0 + m00 - m11 - m22)
    q1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                   (m02 + m20) / s1], 1)
    s2 = safe(1.0 + m11 - m00 - m22)
    q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                   (m12 + m21) / s2], 1)
    s3 = safe(1.0 + m22 - m00 - m11)
    q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                   0.25 * s3], 1)

    choice = np.argmax(np.stack([t, m00, m11, m22], 1), axis=1)
    q = np.choose(choice[:, None], [q0, q1, q2, q3])
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    # canonical sign: w >= 0 (q and -q are the same rotation)
    flip = np.where(q[:, :1] < 0, -1.0, 1.0)
    return q * flip


def rotation_matrix(angle, axis: int):
    """Batched single-axis rotation matrices; axis 0=x, 1=y, 2=z."""
    angle = np.asarray(angle, np.float64)
    n = len(angle)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.tile(np.eye(3), (n, 1, 1))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    rot[:, i, i] = c
    rot[:, j, j] = c
    rot[:, i, j] = -s
    rot[:, j, i] = s
    return rot
