"""Quaternion math for rigid-molecule rotations (port of
mpmc_tpu/utils/quaternion.py).  Quaternions are (w, x, y, z), unit norm.

The reference draws its rotations from jax.random keys; the port's MC
step draws every random number from one pre-drawn uniform table
(mc/metropolis.py), so the samplers here take uniforms, not generators.
"""
from __future__ import annotations

import math

import torch


def rotate(v, q):
    """Rotate vector(s) v by unit quaternion q: v + 2 qw (qv x v) +
    2 qv x (qv x v)."""
    qw = q[..., :1]
    qv = q[..., 1:].expand_as(v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def from_axis_angle(axis, angle):
    """Unit quaternion for rotation by ``angle`` (rad) about unit ``axis``."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]],
                     dim=-1)


def uniform_from(u1, u2, u3):
    """Uniform random rotation quaternion (Shoemake's method) from three
    uniforms in [0, 1), with the component assignment of the fused µVT
    kernel's insert (mc_kernel._kernel_uvt: x, y = sqrt(1-u1) (sin, cos)
    2 pi u2; z, w = sqrt(u1) (sin, cos) 2 pi u3)."""
    a = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    b = torch.sqrt(torch.clamp(u1, min=0.0))
    t2 = 2.0 * math.pi * u2
    t3 = 2.0 * math.pi * u3
    return torch.stack([b * torch.cos(t3), a * torch.sin(t2),
                        a * torch.cos(t2), b * torch.sin(t3)], dim=-1)
