"""The port's fully fused 2D substep against the JAX fast path, slice as a
whole: MPM_P2G_GRID=1 (P2G, the fold and the grid update in one
`p2g_grid(raw=False)` call), MPM_FUSE2D_G2P=1 (the particle update in
`g2p(update=True)`) and both.

Both packages read the two variables (fast2d.py:543, :563-567; the port's
`fast2d.routes`) and start from the same bucketed state (the JAX scene
carried across with `convert`, as tests/test_torch_fast2d.py does).  The
JAX package reads them when it traces, so every case clears JAX's caches
on entry and on exit (tests/test_colliders.py:139-146).  The JAX kernels
run in Pallas interpret mode, the port its plain versions.  The route
cases start from a state in motion (20 substeps of the default route),
since from rest one substep moves v by g dt and x by far less than its
tolerance.  Tolerances are the JAX package's fast-path ones
(tests/test_fast2d.py:56-57): x 1e-7 and v 1e-4 after one substep, x 1e-5
after 100 (test_torch_fast2d.py), and v, C and J also to 1e-5 of their
scale (J: of |J - 1|).  In float32 x moves by about its ulp a substep, so
the displacement, which is what a wrong blend or time step in the fused
tail would change, is held in float64 against the port's default route.
"""

import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import MPMConfig as MPMConfig_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast2d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.parallel import fast_domain
from mpm_flip98a_tpu_torch.parallel.mesh import SlabMesh

_FAST_KW = dict(  # tests/test_fast2d.py:17-25, tests/test_determinism.py:16-18
    dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
    num_particles_y=32, flip_blend=0.98,
)
FAST = MPMConfig(**_FAST_KW, transfer=TransferKind.PIC)
FAST_T = MPMConfig_t(**_FAST_KW, transfer=TransferKind_t.PIC)
# JAX's bucketing and substep, each as one program: called eagerly they
# compile every operation on its own, several seconds a scene.
from_particles_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
substep_jax = jax.jit(fast2d_jax.substep, static_argnames=("scene",))
SETTINGS = {   # name: (MPM_P2G_GRID, MPM_FUSE2D_G2P)
    "p2g_grid": ("1", "0"),
    "fuse_g2p": ("0", "1"),
    "both": ("1", "1"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch, request):
    """Sets the two variables for one case, JAX's trace caches cleared on
    entry and on exit."""
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)

    def set_(p2g_grid, fuse_g2p):
        monkeypatch.setenv("MPM_P2G_GRID", p2g_grid)
        monkeypatch.setenv("MPM_FUSE2D_G2P", fuse_g2p)
    return set_


def _setup(p, scene):
    """JAX state and the port's copy of it, in identical bucket layouts."""
    spec = fast2d_jax.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = from_particles_jax(p, scene.cfg, spec)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast2d.FastSpec(spec.rows, spec.capacity)
    return (scene, spec, b), (scene_t, spec_t, convert.buckets_from_numpy(fields, device="cpu"))


@functools.lru_cache(maxsize=None)
def _dam(cfg=FAST):
    return _setup(*scenes_jax.dam_break_2d(cfg, dtype=np.float32))


def _np(b, name):
    a = getattr(b, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tracks(got, want, x_atol, v_atol=None):
    np.testing.assert_array_equal(_np(got, "mask"), _np(want, "mask"))
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(got, name), _np(want, name), rtol=0, atol=x_atol)
    for name in ("v0", "v1") if v_atol is not None else ():
        np.testing.assert_allclose(_np(got, name), _np(want, name), rtol=0, atol=v_atol)


_DEFAULT_ROUTE = {"MPM_P2G_GRID": "0", "MPM_FUSE2D_G2P": "0"}


@functools.lru_cache(maxsize=None)
def _moving_fields():
    """The dam after 20 substeps of the port's default route (plain
    versions): every field as numpy, in JAX's bucket layout."""
    _, (scene_t, spec_t, b_t) = _dam()
    with mock.patch.dict(os.environ, _DEFAULT_ROUTE):
        b_t = fast2d.run(b_t, scene_t, spec_t, 20)
    assert int(b_t.overflow) == 0
    return {f.name: getattr(b_t, f.name).numpy() for f in dataclasses.fields(b_t)}


def _moving():
    """The JAX scene, spec and state and the port's, both at `_moving_fields`."""
    (scene, spec, _), (scene_t, spec_t, _) = _dam()
    fields = _moving_fields()
    b = fast2d_jax.FluidBuckets(**{n: jnp.asarray(a) for n, a in fields.items()})
    return (scene, spec, b), (scene_t, spec_t, convert.buckets_from_numpy(fields, device="cpu"))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_routes_match_jax(env, setting):
    """One substep and 100 under each setting from a state in motion, the
    port against JAX; the fused-G2P route leaves F, Jp and the lagged
    nodal fields alone.  C is held to one term of its sum: C11 near the
    walls cancels to about a fifth of 4 |v|max / dx, and the default route
    differs from JAX there by the same 1.1e-5 of C's own largest entry.
    After 100 substeps the default route itself is 2.1e-5 (v) and 3.8e-5
    (C) of their largest entries and one ulp of J from JAX (float32 sums
    in another order), so v and C are held to 1e-4 there and J to 1e-6;
    the float64 test below holds the fused tail's wiring tightly."""
    env(*SETTINGS[setting])
    (scene, spec, b), (scene_t, spec_t, b_t) = _moving()
    use_grid, fuse_g2p = fast2d.routes(scene_t)
    assert (use_grid, fuse_g2p) == tuple(v == "1" for v in SETTINGS[setting])
    b1 = substep_jax(b, scene)
    b1_t = fast2d.substep(b_t, scene_t)
    _tracks(b1_t, b1, 1e-7, 1e-4)
    c_term = 4.0 * float(scene_t.cfg.inv_dx)
    _state_tracks(b1_t, b1, 1e-5, c_term=c_term)
    if fuse_g2p:
        for name in ("F00", "F01", "F10", "F11", "Jp", "jbar_s", "p_s", "div_s"):
            np.testing.assert_array_equal(_np(b1_t, name), _np(b_t, name), err_msg=name)
            np.testing.assert_array_equal(_np(b1, name), _np(b, name), err_msg=name)
    out = fast2d_jax.run(b, scene, spec, 100)
    out_t = fast2d.run(b_t, scene_t, spec_t, 100)
    _tracks(out_t, out, 1e-5)
    _state_tracks(out_t, out, 1e-4, c_term=c_term, j_atol=1e-6)
    assert int(out.overflow) == int(out_t.overflow) == 0


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_routes_match_the_default_route_in_float64(env, setting):
    """20 substeps from the state in motion in float64 through the plain
    versions under each setting against the default route: v, C, J and the
    displacement to 1e-6 of their scale.  The fused tail rounds 1 - alpha
    once from a double (as JAX's kernel does) where the default route
    subtracts two float32 values: 2e-8 of vpic apart, far under the bound;
    a wrong blend weight, time step or C term is not."""
    _, (scene_t, spec_t, _) = _dam()
    start = _f64(convert.buckets_from_numpy(_moving_fields(), device="cpu"))
    with mock.patch.dict(os.environ, _DEFAULT_ROUTE):
        ref = fast2d.run(start, scene_t, spec_t, 20, plain=True)
    env(*SETTINGS[setting])
    got = fast2d.run(start, scene_t, spec_t, 20, plain=True)
    assert got.v0.dtype == torch.float64 and int(got.overflow) == 0
    _state_tracks(got, ref, 1e-6, (start, start))


def test_p2g_grid_on_the_prepped_branch_and_colliders_match_jax(env):
    """MPM_P2G_GRID=1 on the prepped branch (the stabilized switch set:
    F-bar, the penalty EBC, pressure mixing) and on dam2d_obstacle at 37^2
    (the collider in the kernel's node pass), one substep each."""
    env("1", "0")
    stab = dataclasses.replace(FAST, use_fbar=True, use_penalty_ebc=True,
                               pressure_mixing_ratio=1.0)
    cfg_obs = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, flip_blend=0.98,
                        transfer=TransferKind.PIC)   # tests/test_colliders.py:22-28
    cases = {
        "stab": _dam(stab),
        "obstacle": _setup(*scenes_jax.dam_break_obstacle_2d(
            cfg_obs, dtype=np.float32, center_frac=(0.12, 0.10))),
    }
    for name, ((scene, _, b), (scene_t, _, b_t)) in cases.items():
        assert fast2d.routes(scene_t) == (True, False), name
        b1 = substep_jax(b, scene)
        b1_t = fast2d.substep(b_t, scene_t)
        _tracks(b1_t, b1, 1e-7, 1e-4)
        np.testing.assert_allclose(_np(b1_t, "J"), _np(b1, "J"), rtol=0, atol=1e-6)
        if name == "obstacle":
            free = fast2d.substep(b_t, dataclasses.replace(scene_t, colliders=()))
            assert np.abs(_np(free, "v1") - _np(b1_t, "v1")).max() > 1e-4


def test_p2g_grid_interior_is_the_unfused_grid(env):
    """The in-kernel node pass against the port's unfused pipeline
    (fold_rows + `_grid_update2d`) on the same sums: interior rows within
    the JAX package's atol of 1e-6 (tests/test_p2g_grid.py:68-70), pad
    rows exactly zero; fused and prepped (F-bar + mixing: the ext
    channels) branches."""
    env("0", "0")
    for cfg in (FAST_T, dataclasses.replace(FAST_T, use_fbar=True, pressure_mixing_ratio=0.5)):
        p_t, scene_t = scenes.dam_break_2d(cfg, dtype=np.float32)
        spec = fast2d.FastSpec.for_particles(cfg, p_t, headroom=2.0)
        b_t = fast2d.from_particles(p_t, cfg, spec, device="cpu")
        data, _, counts = fast2d.transfer_inputs(b_t, scene_t)
        grid = fast2d._grid(data, counts, scene_t, False, None, p2g_grid=True)[0]
        ref = fast2d._grid(data, counts, scene_t, False, None)
        r = b_t.shape[0]
        assert grid.shape == (r + 4, ref.shape[1], cfg.num_grids)
        np.testing.assert_allclose(grid[1 : r + 1].numpy(), ref.numpy(), rtol=0, atol=1e-6)
        assert not grid[0].any() and not grid[r + 1 :].any()


def test_fused_g2p_on_shards_matches_one_device(env):
    """MPM_FUSE2D_G2P=1 on 4 slab shards (`fast_domain.make_run` through
    `substep(domain=...)`: `p2g_grid`'s raw sums, the halo exchange, the
    grid update, the prepadded `g2p(update=True)`, as JAX's `_finish_fused`
    domain branch, fast2d.py:452-456) against the port's one device under
    the same variable: one substep, v, C and J slot for slot in bucket
    order to 1e-6 of their scale (x moves less than its float32 ulp from
    rest); then 20 substeps in float64 through the plain versions, the
    displacement too, to 1e-9 (tests/test_torch_fast_domain.py's bounds)."""
    env("0", "1")
    p_t, scene_t = scenes.dam_break_2d(FAST_T, dtype=np.float32)
    mesh = SlabMesh(4, "cpu")
    spec = fast_domain.FastDomainSpec.for_particles(scene_t.cfg, 4, p_t, headroom=2.0)
    spec1 = fast2d.FastSpec.for_particles(scene_t.cfg, p_t, headroom=2.0)
    b1 = fast2d.from_particles(p_t, scene_t.cfg, spec1, device="cpu")
    bs = fast_domain.distribute(p_t, scene_t.cfg, spec, mesh)
    run = fast_domain.make_run(scene_t, spec, mesh)
    _state_tracks(run(bs, 1), fast2d.run(b1, scene_t, spec1, 1), 1e-6)
    starts = (_f64(bs), _f64(b1))
    got = run(starts[0], 20, plain=True)
    ref = fast2d.run(starts[1], scene_t, spec1, 20, plain=True)
    assert got.v0.dtype == torch.float64 and int(got.overflow.sum()) == 0
    _state_tracks(got, ref, 1e-9, starts)
    # The fused route ran: F stayed at the identity on every live slot.
    assert bool((got.F00[got.mask > 0] == 1.0).all())
    assert tk.LAUNCHES["g2p"] == 0


def _f64(b):
    """The state in float64: the plain versions run in any float dtype."""
    return dataclasses.replace(b, **{f.name: getattr(b, f.name).double()
                                     for f in dataclasses.fields(b)
                                     if getattr(b, f.name).is_floating_point()})


def _state_tracks(got, ref, tol, starts=None, c_term=None, j_atol=None):
    """v, C and J of the live slots in bucket order (either package's
    state), each group to `tol` of its largest entry (J: of its largest
    |J - 1|, or to `j_atol` itself; C, given `c_term` = 4 / dx, of one term
    of its sum, c_term |v|max, as chip_smoke.py's g2p comparisons scale
    it); from `starts`, the displacement x - x_start too."""
    groups = {"v": ("v0", "v1"), "C": ("C00", "C01", "C10", "C11"), "J": ("J",)}

    def live(b, names):
        mask = torch.as_tensor(np.array(_np(b, "mask"))) > 0
        return torch.stack([torch.as_tensor(np.array(_np(b, n)))[mask] for n in names]).double()

    pairs = {g: (live(got, names), live(ref, names)) for g, names in groups.items()}
    if starts is not None:
        x = ("x0", "x1")
        pairs["displacement"] = (live(got, x) - live(starts[0], x),
                                 live(ref, x) - live(starts[1], x))
    for group, (have, want) in pairs.items():
        scale = float(((want - 1.0) if group == "J" else want).abs().max())
        if group == "C" and c_term is not None:
            scale = c_term * float(pairs["v"][1].abs().max())
        if group == "J" and j_atol is not None:
            scale = j_atol / tol
        err = float((have - want).abs().max())
        assert err <= tol * scale, f"{group}: {err:.3e} against {tol} x {scale:.3e}"
