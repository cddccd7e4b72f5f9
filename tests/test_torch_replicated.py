"""The port's replicated-grid particle parallelism (`parallel/replicated.py`) on 4 gloo ranks against the JAX package.

The JAX package shards the padded particles over 4 of the conftest's
virtual CPU devices and merges the grid with `psum`; the port runs the
same 4 slices as 4 processes of a gloo process group
(`parallel/launch.run_ranks`), all cases in one launch.  Tolerances are
tests/test_parallel_replicated.py's: x 1e-10, v 1e-8, J 1e-10 after 50
substeps, x 1e-10 after 30 with every switch, and the padding inert to
1e-12 after 25.  The port's single-device general path on the padded set
is the second reference.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu.parallel import replicated as replicated_jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import stabilized
from mpm_flip98a_tpu_torch.parallel import launch, replicated

N = 4
FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_parallel_replicated.py:18
FIELDS = [f.name for f in dataclasses.fields(ParticlesJax)]
# name: config, substeps, tolerances (absolute).
CASES = {
    "plain": (MPMConfig(**FAST), 50, {"x": 1e-10, "v": 1e-8, "J": 1e-10}),
    "switches": (MPMConfig(**FAST, use_fbar=True, pressure_mixing_ratio=0.5, flip_blend=0.98,
                           transfer=TransferKind.PIC), 30, {"x": 1e-10}),
}
# The dam column's 512 particles padded to a multiple of 12: 4 inert rows,
# in the last rank's slice.
MULTIPLE = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_padded(name):
    p, scene = scenes_jax.dam_break_2d(CASES[name][0])
    return replicated_jax.pad_particles(p, MULTIPLE), scene


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's replicated run on 4 devices."""
    pp, scene = _jax_padded(name)
    mesh = make_mesh(N)
    out = replicated_jax.make_run(scene, mesh)(replicated_jax.shard_particles(pp, mesh),
                                               CASES[name][1])
    return _host(out)


def _port(name):
    """The port's padded particles (its own pad_particles) and scene."""
    p, scene = scenes_jax.dam_break_2d(CASES[name][0])
    return (replicated.pad_particles(convert.particles_from_numpy(_host(p), "cpu"), MULTIPLE),
            convert.scene_from_fields(dataclasses.asdict(scene)))


@functools.lru_cache(maxsize=None)
def _single(name):
    p, scene = _port(name)
    return stabilized.run(p, scene, CASES[name][1])


@pytest.fixture(scope="module")
def ranked():
    """Both cases on 4 gloo ranks in one launch: {case: the collected
    particles, which every rank holds alike}; the references are made
    meanwhile."""
    jobs = []
    for name, (_, n_sub, _) in CASES.items():
        p, scene = _port(name)
        jobs.append((scene, n_sub, {f: getattr(p, f).numpy() for f in FIELDS}))
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(launch.run_ranks, replicated.run_jobs, N, args=(jobs,),
                            device="cpu", backend="gloo", timeout_s=60.0, deadline_s=300.0)
        for ref in [pool.submit(f, name) for name in CASES for f in (_jax, _single)]:
            ref.result()
        per_rank = ranks.result()
    for r in per_rank[1:]:
        for j in range(len(CASES)):
            assert all(np.array_equal(r[j][f], per_rank[0][j][f]) for f in FIELDS)
    return dict(zip(CASES, per_rank[0]))


def test_pad_particles_equals_jax_bitwise():
    for name in CASES:
        want = _host(_jax_padded(name)[0])
        got = _port(name)[0]
        for f in FIELDS:
            g = getattr(got, f).numpy()
            assert g.dtype == want[f].dtype and np.array_equal(g, want[f]), f


def test_padding_is_inert():
    """tests/test_parallel_replicated.py:50-56: 64-padding leaves the real
    particles' x within 1e-12 after 25 substeps (the port's general path)."""
    p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST))
    p = convert.particles_from_numpy(_host(p), "cpu")
    scene = convert.scene_from_fields(dataclasses.asdict(scene))
    ref = stabilized.run(p, scene, 25)
    pad = stabilized.run(replicated.pad_particles(p, 64), scene, 25)
    np.testing.assert_allclose(pad.x[: p.n].numpy(), ref.x.numpy(), rtol=0, atol=1e-12)
    assert torch.isfinite(pad.x).all()


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_jax_replicated(ranked, name):
    want = _jax(name)
    for f, tol in CASES[name][2].items():
        np.testing.assert_allclose(ranked[name][f], want[f], rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_single_device_port(ranked, name):
    ref = _single(name)
    for f, tol in CASES[name][2].items():
        np.testing.assert_allclose(ranked[name][f], getattr(ref, f).numpy(), rtol=0, atol=tol,
                                   err_msg=f)
