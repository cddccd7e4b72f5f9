"""MLS-MPM validation model (counterpart of `mpm_flip98a_tpu/models/mls_mpm.py`).

The reference C++ solver (cpp_validation/mls-mpm88-explained.cpp:49-180):
P2G of mass and momentum with the fused APIC + MLS-MPM stress affine term,
grid normalisation, gravity and the sticky / separating box, G2P with the
APIC C, advection, the MLS F update and the snow plasticity clamp.  The
BASELINE.json north star holds the JAX model to the NumPy oracle within
1e-5 per substep in float32; the port's tests hold this one to both.
Plain torch: the transfers are `ops/transfer.py`'s scatter (`index_add_` on the CPU,
the fixed-order scatter kernel on the card) and gather.
"""

from __future__ import annotations

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import MLS88Config, np_float, scalar
from mpm_flip98a_tpu_torch.ops import mathx
from mpm_flip98a_tpu_torch.ops import transfer
from mpm_flip98a_tpu_torch.ops import weights as W
from mpm_flip98a_tpu_torch.state import MLS88Particles


def _stencil(p: MLS88Particles, cfg: MLS88Config):
    offsets = W.stencil_offsets(cfg.dim)
    base, fx = W.base_and_fx(p.x, float(np_float(p.x.dtype)(cfg.inv_dx)))
    wst = W.stencil_weights(W.quadratic_bspline(fx), offsets)          # :60-64, (N, S)
    return offsets, base, fx, wst


def p2g(p: MLS88Particles, cfg: MLS88Config) -> torch.Tensor:
    """P2G (reference: mls-mpm88-explained.cpp:53-102).  Returns the grid
    (G, G, 3) of [m vx, m vy, m] (:46-47)."""
    nd = np_float(p.x.dtype)
    sc = lambda c: scalar(c, p.x.dtype)
    offsets, base, fx, wst = _stencil(p, cfg)
    e = torch.exp(sc(cfg.hardening) * (1.0 - p.Jp))                    # :67
    mu = float(nd(cfg.mu_0)) * e                                       # :68
    lam = float(nd(cfg.lambda_0)) * e                                  # :69
    j = mathx.det2x2(p.F)                                              # :72
    r, _ = mathx.polar_decomp_2d(p.F)                                  # :74-76
    dinv = 4.0 * cfg.inv_dx * cfg.inv_dx                               # :79
    eye = torch.eye(cfg.dim, dtype=p.x.dtype, device=p.x.device)
    pf = (2.0 * mu)[:, None, None] * mathx.mm(p.F - r, mathx.transpose(p.F)) + (
        (lam * (j - 1.0) * j)[:, None, None] * eye)                    # :81
    stress = sc(-(cfg.dt * cfg.vol_p)) * (sc(dinv) * pf)               # :84
    affine = stress + sc(cfg.mass_p) * p.C                             # :89

    dpos = W.stencil_dpos(fx, offsets) * float(nd(cfg.dx))             # :94
    mom = (sc(cfg.mass_p) * p.v)[:, None, :] + mathx.mv(affine[:, None], dpos)   # :96-98
    mass = torch.full(wst.shape + (1,), cfg.mass_p, dtype=p.x.dtype, device=p.x.device)
    values = wst[..., None] * torch.cat([mom, mass], dim=-1)
    return transfer.p2g_scatter(values, base, offsets, cfg.grid_shape)


def grid_update(grid: torch.Tensor, cfg: MLS88Config) -> torch.Tensor:
    """Normalise by mass, gravity, box boundaries
    (reference: mls-mpm88-explained.cpp:104-131)."""
    sc = lambda c: scalar(c, grid.dtype)
    m = grid[..., 2:3]
    has_mass = m > 0
    g = torch.where(has_mass, grid / torch.where(has_mass, m, 1.0), 0.0)     # :110
    vy = g[..., 1] + has_mass[..., 0].to(g.dtype) * sc(cfg.dt * cfg.gravity)   # :113
    coords = torch.arange(cfg.num_nodes, dtype=grid.dtype, device=grid.device) / cfg.num_grid
    xg, yg = coords[:, None], coords[None, :]                                # :118-119
    b, b1 = sc(cfg.boundary), sc(1 - cfg.boundary)
    sticky = (xg < b) | (xg > b1) | (yg > b1)                                # :122-124
    g = torch.where(sticky[..., None], 0.0, torch.stack([g[..., 0], vy, g[..., 2]], dim=-1))
    vy = torch.where(yg < b, torch.clamp(g[..., 1], min=0.0), g[..., 1])     # :126-128
    return torch.stack([g[..., 0], vy, g[..., 2]], dim=-1)


def g2p(p: MLS88Particles, grid: torch.Tensor, cfg: MLS88Config) -> MLS88Particles:
    """G2P, advection, the MLS F update and plasticity
    (reference: mls-mpm88-explained.cpp:133-179)."""
    sc = lambda c: scalar(c, p.x.dtype)
    offsets, base, fx, wst = _stencil(p, cfg)
    dpos = W.stencil_dpos(fx, offsets)                                 # :149 (grid units)
    gv = transfer.g2p_gather(grid[..., :2], base, offsets)             # :150
    wgv = wst[..., None] * gv
    new_v = mathx.seq_sum(wgv, 1)                                      # :153
    new_c = sc(4.0 * cfg.inv_dx) * mathx.dot_sum(wgv[..., :, None], dpos[..., None, :], 1)  # :154

    new_x = p.x + sc(cfg.dt) * new_v                                   # :159
    eye = torch.eye(cfg.dim, dtype=p.x.dtype, device=p.x.device)
    f_trial = mathx.mm(eye[None] + sc(cfg.dt) * new_c, p.F)            # :162
    u, sig, v = mathx.svd_2d(f_trial)                                  # :164-165
    if cfg.plastic:                                                    # :167-170
        sig = torch.clamp(sig, sc(1.0 - 2.5e-2), sc(1.0 + 7.5e-3))
    old_j = mathx.det2x2(f_trial)                                      # :172
    f_new = mathx.mm(u, sig[..., :, None] * mathx.transpose(v))        # :173
    jp_new = torch.clamp(p.Jp * old_j / mathx.det2x2(f_new), sc(0.6), sc(20.0))  # :175-177
    return MLS88Particles(x=new_x, v=new_v, F=f_new, C=new_c, Jp=jp_new)


def substep(p: MLS88Particles, cfg: MLS88Config) -> MLS88Particles:
    return g2p(p, grid_update(p2g(p, cfg), cfg), cfg)


def make_substep(cfg: MLS88Config):
    """The substep closure for a static config (the JAX module's jit
    factory; here a plain closure)."""
    return lambda p: substep(p, cfg)


def run(p: MLS88Particles, cfg: MLS88Config, n_substeps: int) -> MLS88Particles:
    """Advance `n_substeps`, queued on the particles' device without a
    host synchronisation (reference driver pattern, exec.py:21-26)."""
    for _ in range(n_substeps):
        p = substep(p, cfg)
    return p


def init_dam_break(
    n: int = 3000, seed: int = 0, dtype=torch.float32, cfg: MLS88Config = MLS88Config(),
    device="cuda",
) -> MLS88Particles:
    """Reference scene: particles uniform in a 0.16 x 0.16 block at
    (0.13, 0.13) (reference: mls-mpm88-explained.cpp:191-201), drawn from
    the same numpy generator as the JAX model's."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 2)) * 2.0 - 1.0) * 0.08 + np.array([0.13, 0.13])
    return MLS88Particles.init(torch.as_tensor(x).to(dtype=dtype, device=device))
