"""A smoke run of every multi-device strategy on tiny shapes (counterpart of `__graft_entry__.dryrun_multichip`).

    python -c "from mpm_flip98a_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"

`dryrun_multichip(n_devices, device="cuda")` runs, and
checks that nothing overflowed, on n gloo ranks in one launch (one shard
a rank, `parallel.RankMesh`):

- the general path's slab domain (`parallel/domain.py`) for 1 substep,
  every particle collected back;
- the 2D fast path (`parallel/fast_domain.py`) for 2 substeps, and for 1
  with the incompressible projection and CSF surface tension;
- the 3D fast path in n slabs of one axis for 2 substeps;
- the two-axis 3D mesh (n/2 x 2 ranks) for 2 substeps, when n is even
  and at least 4;

and on one device fast3d's elastic drop (the generic-stress branch) for
2 substeps.  The ranks use gloo, since they may share one card (nccl
refuses that).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _ranks(mesh, cfg):
    """Every multi-device leg on this rank: {leg: (overflow, lost)}."""
    from mpm_flip98a_tpu_torch.models import scenes
    from mpm_flip98a_tpu_torch.parallel import domain, fast_domain, fast_domain3d
    from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh

    n, out = mesh.n, {}
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = domain.DomainSpec.for_particles(cfg, n, p, headroom=2.0)
    state, _ = domain.distribute(p, scene, spec, mesh)
    state = domain.make_run(scene, spec, mesh)(state, 1)
    out["domain"] = (int(mesh.psum(state.dropped).sum()), p.n - domain.collect(state, mesh).n)

    def fast(tag, dom, p, scene, spec, mesh, n_sub):
        b = dom.make_run(scene, spec, mesh)(dom.distribute(p, scene.cfg, spec, mesh), n_sub)
        out[tag] = (int(mesh.psum(b.overflow).sum()), 0)

    spec2 = fast_domain.FastDomainSpec.for_particles(cfg, n, p, headroom=2.0)
    fast("fast_domain", fast_domain, p, scene, spec2, mesh, 2)
    cfg_ext = dataclasses.replace(cfg, incompressible=True, surface_tension=1.0)
    p_ext, scene_ext = scenes.dam_break_2d(cfg_ext, dtype=np.float32)
    spec_ext = fast_domain.FastDomainSpec.for_particles(cfg_ext, n, p_ext, headroom=2.0)
    fast("fast_domain ext", fast_domain, p_ext, scene_ext, spec_ext, mesh, 1)
    p3, scene3 = scenes.slab_3d(num_grids=4 * n, particles_per_axis=(16, 16, 4), dt=1e-5)
    spec3 = fast_domain3d.FastDomain3DSpec.for_particles(scene3.cfg, n, p3, headroom=2.0)
    fast("fast_domain3d", fast_domain3d, p3, scene3, spec3, mesh, 2)
    if n % 2 == 0 and n >= 4:
        n0, n1 = n // 2, 2
        p3b, scene3b = scenes.slab_3d(num_grids=max(4 * n0, 4 * n1),
                                      particles_per_axis=(16, 16, 4), dt=1e-5)
        spec3b = fast_domain3d.FastDomain3DSpec.for_particles(scene3b.cfg, (n0, n1), p3b,
                                                              headroom=2.0)
        mesh2 = RankMesh(mesh.device, mesh.backend, grid=(n0, n1))
        fast("two-axis 3d", fast_domain3d, p3b, scene3b, spec3b, mesh2, 2)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    import torch

    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast3d, scenes
    from mpm_flip98a_tpu_torch.parallel import launch

    if torch.device(device).type == "cuda":
        from mpm_flip98a_tpu_torch import _build

        _build.load()   # once here, so that the ranks load it and none builds
    n = n_devices
    cfg = MPMConfig(dtype="float32", num_grids=8 * n + 1, dt=1e-5, num_particles_x=8,
                    num_particles_y=16, flip_blend=0.98, transfer=TransferKind.PIC)
    legs = launch.run_ranks(functools.partial(_ranks, cfg=cfg), n, device=device,
                            backend="gloo", timeout_s=120.0)
    p3m, scene3m = scenes.elastic_drop_3d(num_grids=16, fluid_particles=(8, 8, 4),
                                          block_particles=(4, 4, 4), dt=1e-5)
    spec3m = fast3d.FastSpec3D.for_particles(scene3m.cfg, p3m, headroom=2.0)
    b3m = fast3d.run(fast3d.from_particles(p3m, scene3m.cfg, spec3m, device), scene3m,
                     spec3m, 2)
    bad = {leg: got for leg, got in legs[0].items() if any(got)}
    if int(b3m.overflow.sum()):
        bad["elastic drop 3d"] = (int(b3m.overflow.sum()), 0)
    if bad:
        raise RuntimeError(f"overflow or lost particles (overflow, lost) in {bad}")
