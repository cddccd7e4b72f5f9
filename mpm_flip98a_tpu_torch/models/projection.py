"""Incompressible pressure projection (counterpart of `mpm_flip98a_tpu/models/projection.py`).

A Chorin-style nodal projection (Zhu & Bridson 2005) that makes the grid
velocity discretely divergence-free on fluid nodes each substep, beyond
the reference's weakly-compressible EOS.  The discretisation is the JAX
module's: the scaled pressure q (= dt p / rho) lives on nodes, its forward
difference along each axis is an edge value and the backward difference of
edge values is the nodal divergence, so the CG solves the compact masked
Laplacian

  edge mask  m_a[n]   : edge n -> n+e_a active unless either end is SOLID
  FLUID nodes         : grid mass > floor, strictly inside the walls
  A q [n] = sum_a ( m_a[n] (q[n] - q[n+e_a]) + m_a[n-e_a] (q[n] - q[n-e_a]) )
  b   [n] = -dx sum_a ( v_a[n] - v_a[n-e_a] )                  on FLUID
  v_a[n] -= m_a[n] (q[n+e_a] - q[n]) / dx                      on EVERY edge

with Dirichlet q = 0 at air nodes (the free surface) and Neumann at solid
ones (walls, rigid-collider interiors).  Neighbour shifts are `torch.roll`,
as the reference's `jnp.roll`: wrapped values land on out-of-wall nodes
whose edge masks are zero.

The solver is the reference's Jacobi-preconditioned CG with its exits: the
iteration cap, the relative-residual exit, the breakdown guard and the
divergence guard (a diverged solve drops the whole correction).  JAX runs
it as one `lax.while_loop` on the device.  Here the loop is a host loop
that never reads a value per iteration: a device-side `active` flag (the
while-loop's condition) gates every update through `torch.where`, so a
finished solve stays frozen, and the host reads the flag once every
CHECK_EVERY iterations to stop early.  The result is the while-loop's,
operation for operation.

Slab shards (`shards=True`): every tensor carries the shard as dim 0 and
its d grid dims after it.  The CG's dot products sum each shard's owned
rows (`own`) and then the shards, and the caller's `halo` refreshes the
halo rows of `p` once per iteration and of q and each v_a at the end
(projection.py:187, :228, :240).  A rank's slab of the general path's
domain decomposition (`mesh`, a `parallel.mesh.RankMesh`) is the JAX
module's `axis` form: the planes are this rank's (L + 4, ...) buffers,
`own` (R,), and each dot product is the ranks' psum of the rank's sum
(the two dot products taken at one point of an iteration share a psum).
Every host decision (the exit check, and through `active` the breakdown
and divergence guards) reads only such reduced values, which every rank
holds bit for bit, so all ranks leave the loop together.  Plain torch
throughout: the JAX module reaches no Pallas kernel.
"""

from __future__ import annotations

import torch

from mpm_flip98a_tpu_torch.config import np_float

# CG iterations between two host reads of the active flag.  The result
# does not depend on it; a measurement of the read's cost sets it to 1.
CHECK_EVERY = 8


def _shift(a: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Neighbour value a[idx + off] along `axis` (`jnp.roll(a, -off, axis)`)."""
    return torch.roll(a, -off, axis)


def divergence_b(v: torch.Tensor, dx: float) -> torch.Tensor:
    """Backward-difference nodal divergence of a (G..., d) velocity grid
    (the projection's own discrete divergence)."""
    d = v.shape[-1]
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for a in range(d):
        acc = acc + (v[..., a] - _shift(v[..., a], a, -1))
    return acc / dx


def _index(idx, a: int, lead: int, d: int, n: int, device) -> torch.Tensor:
    """Global node indices along grid axis `a`, broadcastable against the
    (shards?, G...) planes: `idx` as given (a (n, R) shard table or (R,)),
    else arange(n)."""
    if idx is None:
        idx = torch.arange(n, device=device)
    shape = [1] * (lead + d)
    shape[lead + a] = -1
    if idx.dim() == 2:          # (shards, rows): one table per shard
        shape[0] = idx.shape[0]
    return idx.reshape(shape)


def project_planes(
    vs,
    g_m: torch.Tensor,
    floor,
    *,
    dx: float,
    lo: int,
    hi: int,
    iters: int = 60,
    tol: float = 1e-4,
    row_index0: torch.Tensor = None,
    row_index1: torch.Tensor = None,
    shards: bool = False,
    halo=None,
    own: torch.Tensor = None,
    solid_extra: torch.Tensor = None,
    mesh=None,
):
    """Plane-form core: `vs` holds the d velocity components, each shaped
    like `g_m` (grid axis a of the planes is component a's axis).

    `lo` / `hi` are the wall node thresholds (PAD, G-1-PAD) in global node
    indices: nodes at or beyond them along any axis are solid, and so are
    the nodes of `solid_extra` (rigid-collider interiors).  `floor` (a
    float or a 0-dim tensor) classifies fluid nodes.  With `shards` the
    planes are (n, L + 4, ...) slab buffers: `row_index0` (n, L + 4) holds
    their global axis-0 rows (`row_index1`, (R1 + 4,), the 3D axis-1 pad
    rows), `own` (n, L + 4) bool marks the owned rows and `halo` refreshes
    the halo rows of a plane in place.  With `mesh` (a RankMesh) the planes
    are this rank's slab: `row_index0` and `own` are (R,), `halo` refreshes
    its halo rows from the neighbouring ranks, and the sums run over the
    ranks; with `shards` as well they are this rank's (1, L + 4, ...)
    block of a fast path's slab buffers.

    Returns (vs_projected, q, residual_ratio): q is the scaled pressure
    (p = q rho / dt), residual_ratio = |r| / |b| at exit (a 0-dim tensor).
    """
    lead = 1 if shards else 0
    d = len(vs)
    shape = g_m.shape
    dt_ = g_m.dtype
    dev = g_m.device
    nd = np_float(dt_)
    tiny = float(torch.finfo(dt_).tiny)
    sync = halo if ((shards or mesh is not None) and halo is not None) else (lambda x: x)
    ax = lambda a: lead + a     # tensor dim of grid axis a

    def gsums(*xs):
        """Each x summed over the grid (and the shards or ranks); on ranks
        the sums ride one psum together, each still its own element."""
        if shards:
            sums = tuple(x.sum(dim=tuple(range(1, x.dim()))).sum() for x in xs)
        else:
            sums = tuple(x.sum() for x in xs)
        if mesh is not None:
            return mesh.psum(torch.stack(sums)).unbind()
        return sums

    # ---- masks (global node indices on decomposed axes) -----------------
    per_axis = {0: row_index0, 1: row_index1}
    solid = torch.zeros(shape, dtype=torch.bool, device=dev)
    for a in range(d):
        idx = _index(per_axis.get(a), a, lead, d, shape[ax(a)], dev)
        solid = solid | (idx <= lo) | (idx >= hi)
    if solid_extra is not None:
        solid = solid | solid_extra.expand(shape)
    fluid = (g_m > floor) & ~solid
    fluid_f = fluid.to(dt_)
    nonsolid = (~solid).to(dt_)
    if own is None:
        owned = lambda x: x     # the reference multiplies by ones
    else:
        ownf = own.to(dt_).reshape(own.shape + (1,) * (len(shape) - own.dim()))
        owned = lambda x: x * ownf
    edge = [nonsolid * _shift(nonsolid, ax(a), 1) for a in range(d)]
    edge_back = [_shift(e, ax(a), -1) for a, e in enumerate(edge)]

    def lap(q):
        acc = torch.zeros(shape, dtype=dt_, device=dev)
        for a in range(d):
            acc = acc + edge[a] * (q - _shift(q, ax(a), 1))
            acc = acc + edge_back[a] * (q - _shift(q, ax(a), -1))
        return acc * fluid_f

    # Jacobi preconditioner: the diagonal of the masked operator.
    diag = torch.zeros(shape, dtype=dt_, device=dev)
    for a in range(d):
        diag = diag + edge[a] + edge_back[a]
    diag_safe = torch.where(fluid & (diag > 0), diag, 1.0)

    def precond(r):
        return (r / diag_safe) * fluid_f

    # RHS of the dx^2-scaled compact equation; the backward divergence at
    # a slab's first owned row reads the halo row below, which the caller
    # keeps valid.
    div = torch.zeros(shape, dtype=dt_, device=dev)
    for a in range(d):
        div = div + (vs[a] - _shift(vs[a], ax(a), -1))
    b = owned(-div * float(nd(dx)) * fluid_f)
    z0 = precond(b)
    b2, rho = gsums(b * b, owned(b * z0))
    thresh = float(nd(tol * tol)) * b2

    q, r, p, rs = b * 0, b, z0, b2
    good = torch.ones((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)   # breakdown / diverged
    eps_bd, big = float(nd(1e-9)), float(nd(1e6))
    for it in range(iters):
        # The while-loop's condition (projection.py:216-218); monotone, so
        # once False every later iteration is frozen too.
        active = ~done & (rs > thresh)
        if it and it % CHECK_EVERY == 0 and not bool(active):
            break
        p = sync(p)
        ap = owned(lap(p))
        # Breakdown guard (a singular system: fluid enclosed by solid).
        pap, pp = gsums(owned(p * ap), owned(p * p))
        breakdown = pap <= eps_bd * pp
        alpha = torch.where(breakdown, 0.0, rho / torch.clamp(pap, min=tiny))
        q_new = q + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        rs_new, rho_new = gsums(owned(r_new * r_new), owned(r_new * z))
        # Divergence guard: a blown-up residual drops the whole correction.
        diverged = ~torch.isfinite(rs_new) | (rs_new > big * b2)
        p_new = z + (rho_new / torch.clamp(rho, min=tiny)) * p
        q = torch.where(active, q_new, q)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rho = torch.where(active, rho_new, rho)
        rs = torch.where(active, rs_new, rs)
        good = good & ~(active & diverged)
        done = done | (active & (breakdown | diverged))

    # q lives on fluid nodes (Dirichlet 0 elsewhere); a diverged solve
    # contributes nothing.  Refresh the halos before the edge corrections.
    q = sync(q * fluid_f * good.to(dt_))
    s = float(nd(1.0 / dx))
    out = []
    for a in range(d):
        gq = edge[a] * (_shift(q, ax(a), 1) - q) * s
        out.append(sync(vs[a] - gq))
    resid = torch.sqrt(rs / torch.clamp(b2, min=tiny))
    return tuple(out), q, resid


def project(
    v: torch.Tensor,
    g_m: torch.Tensor,
    floor,
    *,
    dx: float,
    lo: int,
    hi: int,
    iters: int = 60,
    tol: float = 1e-4,
    solid_extra: torch.Tensor = None,
):
    """Stacked-layout wrapper: make `v` (G..., d) discretely
    divergence-free on fluid nodes (one device; see `project_planes`)."""
    d = v.shape[-1]
    vs, q, resid = project_planes(
        tuple(v[..., a] for a in range(d)), g_m, floor, dx=dx, lo=lo, hi=hi,
        iters=iters, tol=tol, solid_extra=solid_extra,
    )
    return torch.stack(vs, dim=-1), q, resid
