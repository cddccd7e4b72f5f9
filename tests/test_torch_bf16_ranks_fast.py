"""The fast paths one shard per rank (`parallel.RankMesh`) from bfloat16 particles.

The fast paths compute in float32: `fast2d.from_particles` and
`fast3d.from_particles` cast bfloat16 particles, as the JAX package's
do.  So a run from bf16 particles must be bitwise the run from their
float32 cast, on ranks as on one device and on `SlabMesh`
(tests/test_torch_bf16_io.py).  One launch of 4 gloo ranks runs every
case twice, from the bf16 particles and from their float32 cast
(tests/torch_bf16_rank_jobs.py; the scenes are those of
tests/torch_fast_rank_jobs.py cast to bf16):

- `fast_domain` on 4 ranks, the split column whose slots migrate both
  ways (20 substeps);
- `fast_domain3d` on 4 ranks and on the 2 x 2 rank grid (20 substeps of
  the thrown 3D column, which cross the window edges);
- `fast_replicated` (10 substeps);
- `Simulation(mesh=RankMesh)`: a frame written by rank 0 (positions
  widened to float32, `state.host_array`), a per-rank checkpoint
  directory, a fresh Simulation resumed from it for a second frame.

The specs of the bf16 particles equal JAX's for the same bits (the JAX
package's host bucketing widens bf16 positions to float32 too).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_bf16_rank_jobs as rank_jobs
from mpm_flip98a_tpu.config import MPMConfig as MPMConfigJax
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.parallel import fast_domain as fd_jax
from mpm_flip98a_tpu.parallel import fast_domain3d as fd3_jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu_torch.parallel import launch

N = 4
JOBS = {
    "fast2d": dict(kind="fast2d", n=20),
    "fast3d": dict(kind="fast3d", grid=None, n=20),
    "fast3d_2x2": dict(kind="fast3d", grid=(2, 2), n=20),
    "fast_replicated": dict(kind="fast_replicated", scene="replicated", n=10),
    "simulation": dict(kind="simulation", tag="sim", n=5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every job on 4 gloo ranks in one launch: {case: rank 0's result}
    (its gathered states are every rank's), and "out", the jobs' folder."""
    out = str(tmp_path_factory.mktemp("bf16_fast_ranks"))
    jobs = [dict(job, out=out) for job in JOBS.values()]
    per_rank = launch.run_ranks(rank_jobs.run_jobs, N, args=(jobs,), device="cpu",
                                backend="gloo", timeout_s=60.0, deadline_s=300.0)
    for r in per_rank[1:]:
        for j, name in enumerate(JOBS):
            if name != "simulation":
                _assert_same(r[j]["bf16"]["end"], per_rank[0][j]["bf16"]["end"], name)
    return {**dict(zip(JOBS, per_rank[0])), "out": out}


def _assert_same(a: dict, b: dict, what: str):
    for name, x in a.items():
        y = b[name]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f"{what}: {name} differs"


def _jax_particles(p) -> ParticlesJax:
    """The port's particles as the JAX package's, bit for bit (bf16
    through its 16-bit patterns)."""
    def arr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return ParticlesJax(**{f.name: arr(getattr(p, f.name)) for f in dataclasses.fields(p)})


def _jax_cfg(cfg) -> MPMConfigJax:
    return MPMConfigJax(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("name", ["fast2d", "fast3d", "fast3d_2x2", "fast_replicated"])
def test_bf16_fast_rank_run_is_the_float32_cast_run(ranked, name):
    """The ranks' spec, bucketed start and state after the run from bf16
    particles are bitwise those from their float32 cast; slots live."""
    got = ranked[name]
    assert got["bf16"]["spec"] == got["float32"]["spec"]
    _assert_same(got["bf16"]["start"], got["float32"]["start"], f"{name} start")
    _assert_same(got["bf16"]["end"], got["float32"]["end"], f"{name} end")
    assert got["bf16"]["end"]["x0"].dtype == np.float32
    assert (got["bf16"]["end"]["mask"] > 0).sum() == (got["bf16"]["start"]["mask"] > 0).sum() > 0


@pytest.mark.parametrize("name", ["fast2d", "fast3d", "fast3d_2x2"])
def test_bf16_fast_rank_spec_is_jax(ranked, name):
    """The spec the ranks built from the bf16 particles equals the JAX
    package's for the same bits."""
    p16, scene = rank_jobs.fast_scene("3d" if name.startswith("fast3d") else "migrate")
    pj, cfg = _jax_particles(p16), _jax_cfg(scene.cfg)
    if name == "fast2d":
        want = fd_jax.FastDomainSpec.for_particles(cfg, N, pj, headroom=2.0)
    else:
        grid = JOBS[name]["grid"]
        want = fd3_jax.FastDomain3DSpec.for_particles(cfg, grid or N, pj, headroom=2.0)
    got = ranked[name]["bf16"]["spec"]
    for key, value in dataclasses.asdict(want).items():
        assert got[key] == value, (key, got[key], value)


def test_bf16_fast_replicated_spec_is_jax(ranked):
    """fast_replicated's per-rank layout from the bf16 particles: JAX's
    worst share's capacity (fast_replicated.py:45-57)."""
    p16, scene = rank_jobs.fast_scene("replicated")
    pj, cfg = _jax_particles(p16), _jax_cfg(scene.cfg)
    cap = max(fast2d_jax.FastSpec.for_particles(
        cfg, ParticlesJax(**{f: getattr(pj, f)[r::N] for f in pj.__dataclass_fields__}),
        2.0).capacity for r in range(N))
    assert ranked["fast_replicated"]["bf16"]["spec"] == {"rows": cfg.num_grids, "capacity": cap}


def test_bf16_simulation_on_ranks_frames_and_checkpoint(ranked):
    """Simulation(mesh=RankMesh) from bf16 particles: rank 0's VTK frame
    holds the positions (float32, finite), the state after the frame and
    the resumed state after a second one are bitwise the float32 cast's,
    and every rank wrote its shard of the checkpoint directory."""
    got = ranked["simulation"]
    bf16, f32 = got["bf16"], got["float32"]
    x = bf16["positions"]
    assert x.dtype == np.float32 and np.isfinite(x).all() and len(x) > 0
    assert np.array_equal(bf16["vtk"][:, :2].astype(np.float32), x)
    np.testing.assert_array_equal(x, f32["positions"])
    _assert_same(bf16["first"], f32["first"], "first frame")
    _assert_same(bf16["resumed"], f32["resumed"], "resumed frame")
    assert bf16["frame_count"] == f32["frame_count"] == 2
    assert not np.array_equal(bf16["resumed"]["x0"], bf16["first"]["x0"])
    ck = os.path.join(ranked["out"], "sim_ck")
    assert sorted(os.listdir(ck)) == [f"shard-{r:05d}.npz" for r in range(N)]
