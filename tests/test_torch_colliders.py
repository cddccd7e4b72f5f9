"""The port's rigid SDF colliders against the JAX package: the module, 2D.

`models/colliders` (sphere, box and halfspace in 2D and 3D; slip, sticky,
surface velocity, spinner, kinematic center) against the JAX module on
seeded points; the 2D fast path on `dam_break_obstacle_2d` against JAX
`fast2d.substep` / `fast2d.run`.  The spinning plow (the kinematic time
threaded through `run`) and the three collider scenarios through the CLI
are in tests/test_torch_colliders_kinematic.py, the slab-sharded plow
against one device in tests/test_torch_colliders_sharded.py, on this
module's scenes and setup.  The JAX kernels run in Pallas interpret mode;
the port runs its plain versions.
Comparisons are slot by slot.  Tolerances: the module to 1e-6 of each
quantity's scale; one substep to 1e-7 on x and 1e-4 on v
(tests/test_fast2d.py:56-57); runs to 1e-5 on x (tests/test_torch_fast2d.py)
and 1e-5 of max |v| on v.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import colliders as col_jax
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import MPMConfig as MPMConfig_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import colliders as col
from mpm_flip98a_tpu_torch.models import fast2d, scenes

_CFG_KW = dict(dtype="float32", num_grids=37, dt=2e-5, flip_blend=0.98)  # test_colliders.py:22-28
CFG = MPMConfig(**_CFG_KW, transfer=TransferKind.PIC)
L = CFG.domain_length
REL = 1e-6
# JAX's bucketing and substep, each as one program: called eagerly they
# compile every operation on its own, several seconds a scene.
from_particles_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
substep_jax = jax.jit(fast2d_jax.substep, static_argnames=("scene",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


def _variants(kind, dim):
    """Collider fields of `kind` in `dim` dimensions: slip and static; sticky
    with a surface velocity and a moving center; a spinner (slip, moving)."""
    c = (0.21, 0.18, 0.2)[:dim]
    shape = dict(
        sphere=dict(radius=0.09),
        box=dict(half_extents=(0.08, 0.05, 0.07)[:dim]),
        halfspace=dict(normal=(0.3, 1.0, 0.4)[:dim]),
    )[kind]
    spin = (35.0,) if dim == 2 else (4.0, -7.0, 30.0)
    return [
        dict(kind=kind, center=c, **shape),
        dict(kind=kind, center=c, sticky=True, velocity=(0.3, -0.2, 0.1)[:dim],
             center_velocity=(-0.4, 0.25, 0.5)[:dim], **shape),
        dict(kind=kind, center=c, angular=spin, center_velocity=(0.6, 0.0, -0.3)[:dim],
             velocity=(0.0, 0.5, 0.0)[:dim], **shape),
    ]


def _points(dim, seed):
    """Broadcast per-axis coordinates ((n, 1), (1, n)[, ...]) around the
    colliders, and seeded velocities of the broadcast shape."""
    rng = np.random.default_rng(seed)
    n = (23, 19, 17)[:dim]
    coords = []
    for a in range(dim):
        shape = [1] * dim
        shape[a] = n[a]
        coords.append(rng.uniform(0.0, 0.42, n[a]).astype(np.float32).reshape(shape))
    vs = [rng.normal(0.0, 1.0, n).astype(np.float32) for _ in range(dim)]
    return coords, vs


def _phi64(fields, coords, t):
    """float64 signed distance (the JAX function in float64) to select the
    points at least 1e-5 l from the surface."""
    c = col_jax.Collider(**fields)
    phi, _ = col_jax.phi_normal(c, [jnp.asarray(x, jnp.float64) for x in coords], t)
    return np.asarray(phi)


def _close(got, want, scale, mask=None):
    got, want = np.broadcast_arrays(np.asarray(got, np.float64), np.asarray(want, np.float64))
    if mask is not None:
        got, want = got[np.broadcast_to(mask, got.shape)], want[np.broadcast_to(mask, want.shape)]
    err = float(np.abs(got - want).max())
    assert err <= REL * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["sphere", "box", "halfspace"])
def test_collider_module_matches_jax(kind, dim):
    coords, vs = _points(dim, seed=dim * 7 + len(kind))
    coords_j = [jnp.asarray(x) for x in coords]
    coords_t = [torch.from_numpy(x) for x in coords]
    fired = 0
    for fields in _variants(kind, dim):
        c_j, c_t = col_jax.Collider(**fields), col.Collider(**fields)
        assert c_t.moving == c_j.moving
        for t in (None, 0.0, 0.4):
            phi_j, n_j = col_jax.phi_normal(c_j, coords_j, t)
            phi_t, n_t = col.phi_normal(c_t, coords_t, t)
            phi_j = np.asarray(phi_j)
            assert phi_t.dtype == torch.float32 and tuple(phi_t.shape) == phi_j.shape
            _close(phi_t, phi_j, np.abs(phi_j).max())
            for a in range(dim):
                _close(n_t[a], n_j[a], 1.0)
            away = np.abs(_phi64(fields, coords, t)) >= 1e-5 * L
            assert away.mean() > 0.95
            inside_t = col.inside_any(coords_t, (c_t,), t).numpy()
            np.testing.assert_array_equal(inside_t[away], np.asarray(
                col_jax.inside_any(coords_j, (c_j,), t))[away])
            got = col.project([torch.from_numpy(v) for v in vs], coords_t, (c_t,), t)
            want = col_jax.project([jnp.asarray(v) for v in vs], coords_j, (c_j,), t)
            scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
            for a in range(dim):
                _close(got[a], want[a], scale, mask=away)
            fired += int(inside_t.sum())
            if t and c_t.moving:    # the center moved with t
                static = col.inside_any(coords_t, (c_t,), None).numpy()
                assert (static != inside_t).any()
    assert fired > 0


def test_several_colliders_in_order_and_node_coords():
    """`project` through a list applies the colliders one after the other,
    as JAX does; `node_coords` and `any_moving` match."""
    coords, vs = _points(3, seed=5)
    fields = [_variants(k, 3)[i] for i, k in enumerate(("sphere", "box", "halfspace"))]
    cs_j = tuple(col_jax.Collider(**f) for f in fields)
    cs_t = tuple(col.Collider(**f) for f in fields)
    assert col.any_moving(cs_t) and not col.any_moving(cs_t[:1])
    got = col.project([torch.from_numpy(v) for v in vs], [torch.from_numpy(x) for x in coords],
                      cs_t, 0.4)
    want = col_jax.project([jnp.asarray(v) for v in vs], [jnp.asarray(x) for x in coords],
                           cs_j, 0.4)
    away = np.ones_like(vs[0], bool)
    for f in fields:
        away &= np.abs(_phi64(f, coords, 0.4)) >= 1e-5 * L
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a in range(3):
        _close(got[a], want[a], scale, mask=away)
    cfg_t = MPMConfig_t(**_CFG_KW, transfer=TransferKind_t.PIC)
    idx = [np.arange(-1, 40).reshape(-1, 1), np.arange(37).reshape(1, -1)]
    got = col.node_coords(cfg_t, [torch.from_numpy(i) for i in idx])
    want = col_jax.node_coords(CFG, [jnp.asarray(i) for i in idx])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def _plow_scene(speed=2.0, start=0.50, angular=()):
    """tests/test_colliders.py:445-452's plow (optionally spinning)."""
    p, scene = scenes_jax.dam_break_2d(CFG, dtype=np.float32)
    plow = col_jax.Collider(
        kind="sphere", center=(start * L, 0.10 * L), radius=0.10 * L, sticky=True,
        center_velocity=(-speed * L, 0.0), angular=angular,
    )
    return p, dataclasses.replace(scene, colliders=(plow,))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """JAX (particles, scene, spec, buckets) and the port's (scene, spec,
    buckets) in identical bucket layouts."""
    if name == "obstacle":
        # The cylinder moved against the column's edge, so that it acts
        # from the first substep (at the default (0.55, 0.10) the front
        # reaches it only after some 5000 substeps).
        p, scene = scenes_jax.dam_break_obstacle_2d(CFG, dtype=np.float32,
                                                    center_frac=(0.12, 0.10))
    elif name == "spin_plow":
        p, scene = _plow_scene(angular=(200.0,))
    else:   # tests/test_colliders.py:536-537's kinematic plow
        p, scene = _plow_scene(speed=2.0, start=0.28)
    spec = fast2d_jax.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = from_particles_jax(p, scene.cfg, spec)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast2d.FastSpec(spec.rows, spec.capacity)
    return (p, scene, spec, b), (scene_t, spec_t, convert.buckets_from_numpy(fields, device="cpu"))


def _np(b, name):
    a = getattr(b, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _f64(b):
    return dataclasses.replace(b, **{f.name: getattr(b, f.name).double()
                                     for f in dataclasses.fields(b)
                                     if getattr(b, f.name).is_floating_point()})


def _assert_tracks(got, want, x_atol, v_atol=None, v_rel=None):
    """Slot for slot: x to x_atol, v to v_atol or to v_rel of max |v|."""
    np.testing.assert_array_equal(_np(got, "mask"), _np(want, "mask"))
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(got, name), _np(want, name), rtol=0, atol=x_atol)
    if v_atol is None:
        v_atol = v_rel * max(float(np.abs(_np(want, n)).max()) for n in ("v0", "v1"))
    for name in ("v0", "v1"):
        np.testing.assert_allclose(_np(got, name), _np(want, name), rtol=0, atol=v_atol)


@pytest.mark.parametrize("builder", ["dam_break_obstacle_2d", "plow_2d",
                                     "dam_break_obstacle_3d"])
def test_collider_scenes_match_jax(builder):
    """Each package builds the scene itself: same particles bit for bit,
    and `convert` carries the JAX scene's colliders into the port's."""
    kw = dict(dtype=np.float32) if builder.endswith("2d") else dict(
        num_grids=16, particles_per_axis=(6, 6, 10))
    p_j, scene_j = getattr(scenes_jax, builder)(**kw)
    p_t, scene_t = getattr(scenes, builder)(**kw)
    for f in dataclasses.fields(p_j):
        np.testing.assert_array_equal(getattr(p_t, f.name).numpy(), np.asarray(getattr(p_j, f.name)))
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))
    assert len(scene_t.colliders) == 1 and isinstance(scene_t.colliders[0], col.Collider)
    assert scene_t.colliders[0].moving == (builder == "plow_2d")


def test_obstacle_substep_and_run_match_jax():
    (_, scene, spec, b), (scene_t, spec_t, b_t) = _setup("obstacle")
    b1 = substep_jax(b, scene)
    b1_t = fast2d.substep(b_t, scene_t)
    _assert_tracks(b1_t, b1, 1e-7, v_atol=1e-4)
    # The obstacle acts: without it the same substep differs by about the
    # approach velocity it removes, g dt = 2e-4 m/s from rest.
    free = fast2d.substep(b_t, dataclasses.replace(scene_t, colliders=()))
    assert np.abs(_np(free, "v1") - _np(b1_t, "v1")).max() > 1e-4
    out = fast2d_jax.run(b, scene, spec, 100)
    out_t = fast2d.run(b_t, scene_t, spec_t, 100)
    _assert_tracks(out_t, out, 1e-5, v_rel=1e-5)
    assert int(out_t.overflow) == int(out.overflow) == 0
