"""Particle data parallelism on the 2D fast path over a rank mesh (counterpart of `mpm_flip98a_tpu/parallel/fast_replicated.py`).

Each rank of a `RankMesh` (parallel/mesh.py) owns a round-robin share of
the particles, rank r the particles r, r + n, r + 2n, ..., in its own
full (G, K) row-bucket layout.  Every substep runs the single-device fast
substep on that share, and the folded P2G sums of the shares merge with
one `psum` (an `all_reduce` of the (G, nch, G) grid) before the grid
update (`fast2d.substep(grid_reduce=...)`).  The grid update, G2P and the
rebucketing then run per rank with no further communication; each rank
decides to rebucket on its own, as the JAX module's `lax.cond` does.  The
kernels are the single-device ones (`p2g_fused` or `p2g`, then `g2p`),
launched on each rank's share.

The grid all-reduce is O(G^2) bytes a substep against the slab paths'
O(halo) (parallel/fast_domain.py): this suits a small grid under many
particles.  One capacity, from the worst share at t = 0, keeps the ranks'
shapes equal; a share that crowds into one row later overflows into the
per-rank `overflow`, which must stay 0, as in the JAX module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpm_flip98a_tpu_torch.config import MPMConfig
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.models.fast2d import FastSpec, FluidBuckets, RunStats
from mpm_flip98a_tpu_torch.models.stabilized import Scene
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh


def share(p, r: int, n: int):
    """Rank r's round-robin share of the particles: p[r::n]."""
    return dataclasses.replace(p, **{f.name: getattr(p, f.name)[r::n]
                                     for f in dataclasses.fields(p)})


def share_spec(p, cfg: MPMConfig, n: int, headroom: float = 2.0) -> FastSpec:
    """The per-rank layout (G, K): K from the worst of the n shares
    (fast_replicated.py:45-57)."""
    cap = max(FastSpec.for_particles(cfg, share(p, r, n), headroom).capacity for r in range(n))
    return FastSpec(rows=cfg.num_grids, capacity=cap)


def distribute(p, cfg: MPMConfig, mesh: RankMesh, headroom: float = 2.0):
    """(this rank's buckets on the mesh's device, the per-rank spec): the
    rank's share bucketed into `share_spec`'s layout; concatenated along K
    in rank order, the ranks' buckets are the JAX module's layout."""
    spec = share_spec(p, cfg, mesh.n, headroom)
    b = fast2d.from_particles(share(p, mesh.rank, mesh.n), cfg, spec, mesh.device)
    return dataclasses.replace(b, overflow=b.overflow.reshape(1)), spec


def make_run(scene: Scene, spec: FastSpec, mesh: RankMesh):
    """`run(b, n_substeps, stats=None, plain=False)`: this rank's share
    stepped with the folded grid summed over the ranks
    (fast_replicated.py:72-101); the rank's own margin check before each
    substep (one host read, counted in `stats`)."""
    cfg = scene.cfg
    fast2d.check_supported(scene)
    reduce = lambda g: mesh.psum(g, tag="grid_psum")

    def run(b: FluidBuckets, n_substeps: int, stats: RunStats = None,
            plain: bool = False) -> FluidBuckets:
        stats = RunStats() if stats is None else stats
        for _ in range(n_substeps):
            stats.host_reads += 1
            if bool(fast2d._needs_rebucket(b, cfg)):
                b = fast2d.rebucket(b, cfg, spec)
                stats.rebuckets += 1
            b = fast2d.substep(b, scene, plain=plain, grid_reduce=reduce)
            stats.substeps += 1
        return b

    return run


def collect(b: FluidBuckets, mesh: RankMesh) -> FluidBuckets:
    """Every rank's share on every rank: the (G, n K) layout of the JAX
    module (rank r's slots at [r K, (r + 1) K)), overflow (n,)."""
    def cat(a):
        got = mesh.all_gather(a, tag="collect")          # (n, G, K) or (n, 1)
        return got.flatten() if a.dim() == 1 else got.transpose(0, 1).flatten(1, 2)

    return dataclasses.replace(b, **{f.name: cat(getattr(b, f.name))
                                     for f in dataclasses.fields(b)})


def collect_positions(b: FluidBuckets, mesh: RankMesh) -> np.ndarray:
    """(N, 2) positions of every rank's live slots, in the layout's order."""
    h = fast2d.to_host(collect(b, mesh))
    return np.stack([h["x0"], h["x1"]], axis=-1)
