"""Triclinic periodic cell: basis, reciprocal basis, minimum image
(port of mpmc_tpu/ops/pbc.py).

Conventions: ``box`` is a (3,3) tensor whose ROWS are the cell vectors, so
a cartesian position is ``frac @ box``.
"""
from __future__ import annotations

import numpy as np
import torch


def cell_volume(box):
    """Cell volume |det(box)| in A^3 ([C] for stacked boxes [C, 3, 3])."""
    return torch.abs(torch.linalg.det(box))


def min_perpendicular_width(box):
    """Minimum distance between opposite cell faces ([C] for stacked
    boxes [C, 3, 3])."""
    v = cell_volume(box)
    a, b, c = box[..., 0, :], box[..., 1, :], box[..., 2, :]
    c01 = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
    c12 = torch.linalg.norm(torch.linalg.cross(b, c, dim=-1), dim=-1)
    c20 = torch.linalg.norm(torch.linalg.cross(c, a, dim=-1), dim=-1)
    return torch.min(torch.stack([v / c12, v / c20, v / c01], -1), -1).values


def default_cutoff(box):
    """Half the minimum perpendicular cell width (the reference's default;
    [C] for stacked boxes)."""
    return 0.5 * min_perpendicular_width(box)


def _apply33(v, m):
    """v @ m for last-axis-3 tensors, unrolled into component arithmetic
    (same association order as the reference, and no matmul for TF32 to
    touch); ``m`` [3, 3], or [C, 1, ..., 3, 3] against ``v`` [C, ..., 3]."""
    return torch.stack(
        [v[..., 0] * m[..., 0, a] + v[..., 1] * m[..., 1, a]
         + v[..., 2] * m[..., 2, a] for a in range(3)], dim=-1)


def min_image(dr, box, box_inv=None):
    """Minimum-image displacement(s) for raw displacement(s) ``dr``.
    ``torch.round`` rounds half to even, like ``jnp.round``.  Stacked
    cells ``box`` [C, 3, 3] (the NPT chains) apply to displacements
    ``dr`` [C, ..., 3], chain c's in its own cell."""
    if box_inv is None:
        box_inv = torch.linalg.inv(box)
    if box.ndim > 2:
        shape = box.shape[:-2] + (1,) * (dr.ndim - box.ndim + 1) + (3, 3)
        box, box_inv = box.reshape(shape), box_inv.reshape(shape)
    frac = _apply33(dr, box_inv)
    frac = frac - torch.round(frac)
    return _apply33(frac, box)


def abc_from_cell(box):
    """(a, b, c, alpha, beta, gamma[deg]) from a row-vector basis —
    the CRYST1 record contents (host-side numpy)."""
    box = np.asarray(box, np.float64)
    a, b, c = (np.linalg.norm(box[i]) for i in range(3))
    cosa = box[1] @ box[2] / (b * c)
    cosb = box[0] @ box[2] / (a * c)
    cosg = box[0] @ box[1] / (a * b)
    return (float(a), float(b), float(c),
            float(np.degrees(np.arccos(np.clip(cosa, -1, 1)))),
            float(np.degrees(np.arccos(np.clip(cosb, -1, 1)))),
            float(np.degrees(np.arccos(np.clip(cosg, -1, 1)))))


def cell_from_abc(a, b, c, alpha_deg, beta_deg, gamma_deg):
    """Row-vector cell basis from lengths + angles (degrees), host numpy:
    a along x, b in the xy plane (the reference's ``abcbasis``)."""
    alpha, beta, gamma = np.deg2rad([alpha_deg, beta_deg, gamma_deg])
    bx = b * np.cos(gamma)
    by = b * np.sin(gamma)
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])
