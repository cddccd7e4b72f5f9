"""A smoke run of every multi-device strategy on tiny shapes (counterpart of `__graft_entry__.dryrun_multichip`).

    python -c "from mpm_flip98a_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"

`dryrun_multichip(n_devices, device="cuda")` runs, and
checks that nothing overflowed:

- the general path's slab domain (`parallel/domain.py`) on n ranks for 1
  substep, every particle collected back;
- the 2D fast path on `SlabMesh(n)` for 2 substeps, and for 1 with the
  incompressible projection and CSF surface tension;
- the 3D fast path in n slabs of one axis for 2 substeps;
- fast3d's elastic drop (the generic-stress branch) for 2 substeps;
- the two-axis 3D mesh (n/2 x 2) for 2 substeps, when n is even and at
  least 4.

The fast paths' shards share `device` (`SlabMesh`); the ranks of the
general domain use gloo, since they may share one card (nccl refuses
that).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _general_domain(mesh, cfg):
    from mpm_flip98a_tpu_torch.models import scenes
    from mpm_flip98a_tpu_torch.parallel import domain

    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = domain.DomainSpec.for_particles(cfg, mesh.n, p, headroom=2.0)
    state, _ = domain.distribute(p, scene, spec, mesh)
    out = domain.make_run(scene, spec, mesh)(state, 1)
    return int(mesh.psum(out.dropped).sum()), p.n - domain.collect(out, mesh).n


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    import torch

    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.parallel import fast_domain, fast_domain3d, launch
    from mpm_flip98a_tpu_torch.parallel.mesh import SlabMesh

    if torch.device(device).type == "cuda":
        from mpm_flip98a_tpu_torch import _build

        _build.load()   # once here, so that the ranks load it and none builds
    n = n_devices
    cfg = MPMConfig(dtype="float32", num_grids=8 * n + 1, dt=1e-5, num_particles_x=8,
                    num_particles_y=16, flip_blend=0.98, transfer=TransferKind.PIC)
    lost = launch.run_ranks(functools.partial(_general_domain, cfg=cfg), n,
                            device=device, backend="gloo", timeout_s=120.0)
    if any(any(r) for r in lost):
        raise RuntimeError(f"the general domain lost particles (dropped, missing): {lost}")

    mesh = SlabMesh(n, torch.device(device))

    def overflow(b) -> int:
        return int(b.overflow.sum())

    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    fspec = fast_domain.FastDomainSpec.for_particles(cfg, n, p, headroom=2.0)
    b = fast_domain.make_run(scene, fspec, mesh)(fast_domain.distribute(p, cfg, fspec, mesh), 2)
    cfg_ext = dataclasses.replace(cfg, incompressible=True, surface_tension=1.0)
    p_ext, scene_ext = scenes.dam_break_2d(cfg_ext, dtype=np.float32)
    espec = fast_domain.FastDomainSpec.for_particles(cfg_ext, n, p_ext, headroom=2.0)
    e = fast_domain.make_run(scene_ext, espec, mesh)(
        fast_domain.distribute(p_ext, cfg_ext, espec, mesh), 1)

    p3, scene3 = scenes.slab_3d(num_grids=4 * n, particles_per_axis=(16, 16, 4), dt=1e-5)
    spec3 = fast_domain3d.FastDomain3DSpec.for_particles(scene3.cfg, n, p3, headroom=2.0)
    b3 = fast_domain3d.make_run(scene3, spec3, mesh)(
        fast_domain3d.distribute(p3, scene3.cfg, spec3, mesh), 2)

    p3m, scene3m = scenes.elastic_drop_3d(num_grids=16, fluid_particles=(8, 8, 4),
                                          block_particles=(4, 4, 4), dt=1e-5)
    spec3m = fast3d.FastSpec3D.for_particles(scene3m.cfg, p3m, headroom=2.0)
    b3m = fast3d.run(fast3d.from_particles(p3m, scene3m.cfg, spec3m, device), scene3m,
                     spec3m, 2)
    runs = {"fast_domain": b, "fast_domain ext": e, "fast_domain3d": b3, "elastic drop 3d": b3m}

    if n % 2 == 0 and n >= 4:
        n0, n1 = n // 2, 2
        p3b, scene3b = scenes.slab_3d(num_grids=max(4 * n0, 4 * n1),
                                      particles_per_axis=(16, 16, 4), dt=1e-5)
        spec3b = fast_domain3d.FastDomain3DSpec.for_particles(scene3b.cfg, (n0, n1), p3b,
                                                              headroom=2.0)
        mesh2 = SlabMesh(n0, torch.device(device), n1)
        runs["two-axis 3d"] = fast_domain3d.make_run(scene3b, spec3b, mesh2)(
            fast_domain3d.distribute(p3b, scene3b.cfg, spec3b, mesh2), 2)
    bad = {name: overflow(r) for name, r in runs.items() if overflow(r)}
    if bad:
        raise RuntimeError(f"overflow in {bad}")
