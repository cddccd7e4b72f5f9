"""Rigid SDF colliders (counterpart of `mpm_flip98a_tpu/models/colliders.py`).

Obstacles defined by a signed distance function (sphere, halfspace,
axis-aligned box) with slip or sticky surfaces, a constant surface
velocity (conveyor), an angular velocity (spinner) and an optional
constant translation of the geometry (kinematic collider).  Collision acts
on grid velocities: a pointwise projection over node planes, so slab
shards need no halo, only global node coordinates.  Every function takes
per-axis tensors that broadcast against each other, as the reference's do.

At a node with signed distance phi <= 0 and outward normal n:

    vrel = v - v_surface
    slip   : vrel' = vrel - min(vrel . n, 0) n   (remove approach only)
    sticky : vrel' = 0
    v      = vrel' + v_surface

Scalars round as the JAX package rounds them: every constant is cast to
the planes' dtype (float32 on the fast paths) before it meets a tensor,
the halfspace normal is normalised in float64 first, and a kinematic
center is center + center_velocity * t in that dtype.  Each operation is a
separate rounded step, in the reference's order; `csrc/p2g3d_grid.cu`
repeats them with round-to-nearest intrinsics, so the inside test agrees
bit for bit between the kernel and `project`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from mpm_flip98a_tpu_torch.config import np_float, scalar
from mpm_flip98a_tpu_torch.models.stabilized import PAD


@dataclasses.dataclass(frozen=True)
class Collider:
    """Static rigid collider (hashable; lives on Scene).

    kind      : 'sphere' | 'halfspace' | 'box'
    center    : sphere/box center / any point on the halfspace surface [m]
    radius    : sphere radius [m] (sphere only)
    half_extents : box half-widths per axis [m] (box only; axis-aligned)
    normal    : halfspace OUTWARD normal (need not be normalized)
    sticky    : sticky (True) or slip (False) surface
    velocity  : constant surface velocity [m/s] (conveyor BC)
    angular   : angular velocity about `center` [rad/s]: (omega_z,) in 2D,
                (wx, wy, wz) in 3D; the surface velocity at a point is
                velocity + omega x (x - center) (spinner BC; the geometry
                itself does not rotate).
    center_velocity : constant velocity of the GEOMETRY [m/s]: at time t
                the center is center + center_velocity * t, and the surface
                velocity gains center_velocity.  Callers pass t (run()'s
                t0 + i dt) to project() / inside_any(); t=None keeps the
                collider static.
    """

    kind: str
    center: Tuple[float, ...]
    radius: float = 0.0
    half_extents: Tuple[float, ...] = ()
    normal: Tuple[float, ...] = ()
    sticky: bool = False
    velocity: Tuple[float, ...] = ()
    angular: Tuple[float, ...] = ()
    center_velocity: Tuple[float, ...] = ()

    def __post_init__(self):
        assert self.kind in ("sphere", "halfspace", "box"), self.kind
        if self.kind == "halfspace":
            assert len(self.normal) == len(self.center), self
        if self.kind == "box":
            assert len(self.half_extents) == len(self.center), self
        if self.velocity:
            assert len(self.velocity) == len(self.center), self
        if self.angular:
            d = len(self.center)
            assert len(self.angular) == (1 if d == 2 else 3), self
        if self.center_velocity:
            assert len(self.center_velocity) == len(self.center), self

    @property
    def moving(self) -> bool:
        return bool(self.center_velocity) and any(v != 0.0 for v in self.center_velocity)


def _center_at(c: Collider, dtype: torch.dtype, t):
    """Per-axis effective center at simulation time t (a host scalar, or
    None = 0), computed in `dtype`: center + center_velocity * t."""
    nd = np_float(dtype)
    if t is None or not c.moving:
        return [float(nd(x)) for x in c.center]
    tt = nd(float(t))
    return [float(nd(c.center[a]) + nd(c.center_velocity[a]) * tt) for a in range(len(c.center))]


def _sum(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def halfspace_normal(c: Collider) -> list:
    """The unit outward normal, normalised in float64 (cast by the caller)."""
    nn = math.sqrt(sum(x * x for x in c.normal))
    return [x / nn for x in c.normal]


def phi_normal(c: Collider, coords, t=None):
    """Signed distance (< 0 inside the solid) and outward normal at the
    broadcastable coordinate tensors `coords` (one per axis), with the
    geometry advected to simulation time `t` for kinematic colliders."""
    d = len(coords)
    dt_ = coords[0].dtype
    ctr = _center_at(c, dt_, t)
    if c.kind == "sphere":
        diff = [coords[a] - ctr[a] for a in range(d)]
        r = torch.sqrt(_sum([x * x for x in diff]))
        r_safe = r.clamp(min=scalar(1e-12, dt_))
        return r - scalar(c.radius, dt_), [x / r_safe for x in diff]
    if c.kind == "box":
        # Exact SDF: q_a = |x_a - c_a| - h_a; phi = |max(q, 0)| + min(max_a
        # q_a, 0).  Outward normal: outside, from the closest surface point;
        # inside, the nearest face's axis (one-hot on argmax q, sign of the
        # offset; ties at edges share it).
        diff = [coords[a] - ctr[a] for a in range(d)]
        q = [diff[a].abs() - scalar(c.half_extents[a], dt_) for a in range(d)]
        qp = [x.clamp(min=0.0) for x in q]
        out_len = torch.sqrt(_sum([x * x for x in qp]))
        qmax = q[0]
        for a in range(1, d):
            qmax = torch.maximum(qmax, q[a])
        phi = out_len + qmax.clamp(max=0.0)
        sgn = [torch.where(x >= 0, 1.0, -1.0).to(dt_) for x in diff]
        safe_out = out_len.clamp(min=scalar(1e-12, dt_))
        face = [(q[a] >= qmax).to(dt_) for a in range(d)]
        face_n = torch.sqrt(_sum([f * f for f in face]))
        inside = qmax <= 0
        n = [
            torch.where(inside, sgn[a] * face[a] / face_n, sgn[a] * qp[a] / safe_out)
            for a in range(d)
        ]
        return phi, n
    nu = [scalar(x, dt_) for x in halfspace_normal(c)]
    phi = _sum([nu[a] * (coords[a] - ctr[a]) for a in range(d)])
    return phi, [torch.full_like(phi, nu[a]) for a in range(d)]


def project(vs, coords, colliders: Tuple[Collider, ...], t=None):
    """Project per-component grid velocity tensors `vs` (one per axis,
    broadcastable with `coords`) through every collider, in order; returns
    the projected list.  `t` advects kinematic colliders, whose translation
    velocity joins the surface velocity."""
    d = len(vs)
    dt_ = vs[0].dtype
    nd = np_float(dt_)
    for c in colliders:
        phi, n = phi_normal(c, coords, t)
        inside = phi <= 0
        vel = c.velocity or (0.0,) * d
        cvel = c.center_velocity or (0.0,) * d
        vsurf = [float(nd(vel[a]) + nd(cvel[a])) for a in range(d)]
        if c.angular:
            # Spinner BC: v_surface += omega x (x - center(t)).
            ctr = _center_at(c, dt_, t)
            r = [coords[a] - ctr[a] for a in range(d)]
            if d == 2:
                w = scalar(c.angular[0], dt_)
                vsurf = [vsurf[0] - w * r[1], vsurf[1] + w * r[0]]
            else:
                wx, wy, wz = (scalar(w_, dt_) for w_ in c.angular)
                vsurf = [
                    vsurf[0] + wy * r[2] - wz * r[1],
                    vsurf[1] + wz * r[0] - wx * r[2],
                    vsurf[2] + wx * r[1] - wy * r[0],
                ]
        vrel = [vs[a] - vsurf[a] for a in range(d)]
        if c.sticky:
            proj = [torch.zeros_like(v) for v in vrel]
        else:
            vn = _sum([vrel[a] * n[a] for a in range(d)])
            approach = vn.clamp(max=0.0)
            proj = [vrel[a] - approach * n[a] for a in range(d)]
        vs = [torch.where(inside, proj[a] + vsurf[a], vs[a]) for a in range(d)]
    return vs


def inside_any(coords, colliders: Tuple[Collider, ...], t=None):
    """Boolean mask of nodes inside ANY collider (phi <= 0): the solid
    nodes of the incompressible projection (`solid_extra` of
    models/projection.py on every path)."""
    inside = None
    for c in colliders:
        m = phi_normal(c, coords, t)[0] <= 0
        inside = m if inside is None else (inside | m)
    return inside


def any_moving(colliders: Tuple[Collider, ...]) -> bool:
    """Does any collider's geometry move?  Callers skip time-threading
    entirely when False."""
    return any(c.moving for c in colliders)


def node_coords(cfg, axis_indices, dtype=torch.float32):
    """Physical node positions from grid indices: x = (idx - PAD) dx.
    `axis_indices` are broadcastable per-axis index tensors (global
    indices on sharded windows)."""
    dx = scalar(cfg.dx, dtype)
    return [(idx.to(dtype) - PAD) * dx for idx in axis_indices]
