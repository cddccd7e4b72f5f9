"""The port's general path in 2D (`models/stabilized.py`) against the JAX package.

Both packages start from the same state: the JAX scene builder's particles
carried across with `convert`, perturbed with a numpy seed (random v, C,
F near the identity and J = det F, so the stress, APIC and F-bar terms all
act).  The JAX side runs its own `stabilized.run` / `substep_grid` (plain
XLA: the general path reaches no Pallas kernel); its results are cached per
case.  Tolerances, relative to each field's scale (its largest magnitude in
the JAX result; the consistency diagnostic, a position error, takes x's):

  float64  1e-12 after 1 substep, 1e-9 after 20
  float32  after 1 substep, x within 1e-7 and v within 1e-4 absolute (the
           JAX fast path's bounds against this solver, tests/test_fast2d.py)
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.models.colliders import Collider as ColliderJax
from mpm_flip98a_tpu.ops import transfer as transfer_jax
from mpm_flip98a_tpu.ops import weights as weights_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models import stabilized
from mpm_flip98a_tpu_torch.ops import transfer
from mpm_flip98a_tpu_torch.ops import weights

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_stabilized.py:21
FLIP = dict(flip_blend=0.98, transfer=TransferKind.PIC)
E_SOLID, NU_SOLID = 5e4, 0.3
LAME = dict(mu=E_SOLID / (2 * (1 + NU_SOLID)),
            lam=E_SOLID * NU_SOLID / ((1 + NU_SOLID) * (1 - 2 * NU_SOLID)))
TOL64 = {1: 1e-12, 20: 1e-9}

# The switch matrix: transfer x kernel x FLIP, then F-bar x mixing x penalty.
SWITCHES = {
    **{f"{t.value}_{k.value}": dict(transfer=t, kernel=k)
       for t in (TransferKind.APIC, TransferKind.PIC) for k in (KernelKind.BSPLINE, KernelKind.TENT)},
    "flip_bspline": dict(FLIP),
    "flip_tent": dict(FLIP, kernel=KernelKind.TENT),
    **{f"fbar{int(f)}_mix{m}_pen{int(e)}": dict(FLIP, use_fbar=f, pressure_mixing_ratio=m,
                                                use_penalty_ebc=e)
       for f in (False, True) for m in (0.0, 1.0) for e in (False, True)},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(p, seed=0):
    """v, C, F and J of `p` (a JAX Particles) made non-trivial, from a seed."""
    rng = np.random.default_rng(seed)
    n, d = np.asarray(p.x).shape
    dt = np.asarray(p.x).dtype
    f = np.eye(d) + 0.01 * rng.standard_normal((n, d, d))
    return dataclasses.replace(
        p,
        v=jnp.asarray(0.1 * rng.standard_normal((n, d)), dt),
        C=jnp.asarray(10.0 * rng.standard_normal((n, d, d)), dt),
        F=jnp.asarray(f, dt),
        J=jnp.asarray(np.linalg.det(f), dt),
    )


def _corotated(p, scene, plastic):
    p = dataclasses.replace(p, material=jnp.full_like(p.material, mat_jax.FIXED_COROTATED))
    params = dataclasses.replace(scene.params, plastic=plastic, **LAME)
    return p, dataclasses.replace(scene, params=params,
                                  materials_present=(mat_jax.FIXED_COROTATED,))


def _three_materials(p, scene):
    """elastic_drop_2d with half of its neo-Hookean block made corotated."""
    m = np.asarray(p.material).copy()
    block = np.flatnonzero(m == mat_jax.NEO_HOOKEAN)
    m[block[: len(block) // 2]] = mat_jax.FIXED_COROTATED
    return dataclasses.replace(p, material=jnp.asarray(m)), dataclasses.replace(
        scene, materials_present=(0, 1, 2))


def _with_collider(scene, **kw):
    l = scene.cfg.domain_length
    col = ColliderJax(kind="sphere", center=(0.1 * l, 0.15 * l), radius=0.05 * l, **kw)
    return dataclasses.replace(scene, colliders=(col,))


def _jax_case(case, dtype=np.float64):
    """(particles, scene, t0) of a named case, JAX side."""
    if case in SWITCHES:
        cfg = MPMConfig(**FAST, **SWITCHES[case])
    elif case in ("drop3mat",):
        cfg = MPMConfig(**{**FAST, "dt": 1e-5}, **FLIP)
    else:
        cfg = MPMConfig(**FAST, **({} if case.startswith("corotated") else FLIP))
    cfg = dataclasses.replace(cfg, dtype=np.dtype(dtype).name)
    t0 = None
    if case == "drop3mat":
        p, scene = _three_materials(*scenes_jax.elastic_drop_2d(cfg, dtype=dtype))
    else:
        p, scene = scenes_jax.dam_break_2d(cfg, dtype=dtype)
    if case == "tait":
        scene = dataclasses.replace(
            scene, params=dataclasses.replace(scene.params, eos=EOSKind.TAIT))
    elif case == "corotated_plastic":
        p, scene = _corotated(p, scene, plastic=True)
    elif case == "collider_static":
        scene = _with_collider(scene)
    elif case == "collider_moving":
        scene = _with_collider(scene, sticky=True, center_velocity=(0.2, 0.1))
        t0 = 0.013
    return _perturb(p), scene, t0


@functools.lru_cache(maxsize=None)
def jax_run(case, n, dtype=np.float64):
    """JAX's state after n substeps: one compiled substep called n times
    (one compile per case for both horizons), substep i at t0 + i dt."""
    p, scene, t0 = _jax_case(case, dtype)
    if n > 1:
        q = jax_run(case, 1, dtype)[2]
        for i in range(1, n):
            q = stab_jax.run(q, scene, 1, None if t0 is None else t0 + i * scene.cfg.dt)
        return p, scene, q
    return p, scene, stab_jax.run(p, scene, 1, t0)


def _to_port(p, scene):
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    return p_t, convert.scene_from_fields(dataclasses.asdict(scene))


def errors(got, want) -> dict:
    """Per field: max |got - want| over the field's scale."""
    x_scale = float(np.abs(np.asarray(want.x)).max())
    out = {}
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        scale = x_scale if f.name == "consistency" else float(np.abs(w).max())
        diff = float(np.abs(g.astype(np.float64) - w).max())
        out[f.name] = diff / scale if diff else 0.0
    return out


def _assert_tracks(case, n, dtype=np.float64):
    p, scene, want = jax_run(case, n, dtype)
    p_t, scene_t = _to_port(p, scene)
    got = stabilized.run(p_t, scene_t, n, t0=_jax_case(case, dtype)[2])
    if dtype == np.float64:
        errs = errors(got, want)
        bad = {k: v for k, v in errs.items() if v > TOL64[n]}
        assert not bad, f"{case} after {n}: {bad} (all {errs})"
    else:
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-7)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=1e-4)
    return got


def test_weights_and_transfers_match_jax():
    """Stencil weights, P2G scatter and G2P gather at 37^2, with a few
    particles off the grid (their nodes clipped and zeroed)."""
    cfg = MPMConfig(**FAST)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.05, 0.5, (300, 2))
    gx = x * cfg.inv_dx + stabilized.PAD
    offsets = weights_jax.stencil_offsets(2)
    np.testing.assert_array_equal(weights.stencil_offsets(2), offsets)
    base_j, fx_j = weights_jax.base_and_fx(jnp.asarray(gx), 1.0)
    base, fx = weights.base_and_fx(torch.from_numpy(gx), 1.0)
    np.testing.assert_array_equal(base.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(fx.numpy(), np.asarray(fx_j))
    for kind in KernelKind:
        w_j = weights_jax.stencil_weights(weights_jax.kernel_weights(fx_j, kind), offsets)
        w = weights.stencil_weights(weights.kernel_weights(fx, kind), offsets)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(weights.stencil_dpos(fx, offsets).numpy(),
                                  np.asarray(weights_jax.stencil_dpos(fx_j, offsets)))
    vals = rng.standard_normal((300, 9, 3))
    g_j = transfer_jax.p2g_scatter(jnp.asarray(vals), base_j, offsets, cfg.grid_shape)
    g = transfer.p2g_scatter(torch.from_numpy(vals), base, offsets, cfg.grid_shape)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=1e-13)
    grid = rng.standard_normal(cfg.grid_shape + (4,))
    np.testing.assert_array_equal(
        transfer.g2p_gather(torch.from_numpy(grid), base, offsets).numpy(),
        np.asarray(transfer_jax.g2p_gather(jnp.asarray(grid), base_j, offsets)))


@pytest.mark.parametrize("n", [1, 20])
@pytest.mark.parametrize("case", list(SWITCHES))
def test_switch_matrix_tracks_jax(case, n):
    _assert_tracks(case, n)


@pytest.mark.parametrize("n", [1, 20])
@pytest.mark.parametrize("case", ["tait", "drop3mat", "corotated_plastic", "collider_static",
                                  "collider_moving"])
def test_scenes_track_jax(case, n):
    _assert_tracks(case, n)


@pytest.mark.parametrize("case", ["apic_bspline", "fbar1_mix1.0_pen1", "flip_tent",
                                  "drop3mat"])
def test_float32_substep_tracks_jax(case):
    _assert_tracks(case, 1, np.float32)


@pytest.mark.parametrize("case", ["fbar1_mix1.0_pen1", "apic_tent", "collider_moving"])
def test_substep_grid_matches_jax(case):
    """Both outputs of one substep: the particles and the post-update Grid."""
    p, scene, t0 = _jax_case(case)
    step = jax.jit(stab_jax.substep_grid, static_argnames=("scene",))
    p1, g1 = step(p, scene=scene, t=None if t0 is None else jnp.asarray(t0))
    p_t, scene_t = _to_port(p, scene)
    q1, h1 = stabilized.substep_grid(p_t, scene_t, t=t0)
    errs = errors(q1, p1)
    assert max(errs.values()) <= TOL64[1], errs
    for f in dataclasses.fields(g1):
        want = np.asarray(getattr(g1, f.name))
        got = getattr(h1, f.name).numpy()
        assert got.shape == want.shape, f.name
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) / scale <= TOL64[1], f.name


def test_plastic_clamp_acts():
    """The corotated case's clamp changes F (the check above is not
    vacuous) and keeps Jp; the port's J matches JAX's."""
    p, _, want = jax_run("corotated_plastic", 1)
    sig = np.linalg.svd(np.asarray(want.F), compute_uv=False)
    assert sig.max() <= 1.0075 + 1e-12 and sig.min() >= 0.975 - 1e-12
    assert np.array_equal(np.asarray(want.Jp), np.asarray(p.Jp))


@pytest.mark.parametrize("d", [2, 3])
def test_plastic_update_matches_jax(d):
    """`plastic_update` on a mixed batch: fluid, a plastic corotated solid
    and snow (F clamped, snow's Jp tracked)."""
    rng = np.random.default_rng(d)
    n = 96
    f = np.eye(d) + 0.05 * rng.standard_normal((n, d, d))
    jp = rng.uniform(0.7, 1.3, n)
    material = np.array([0, 2, 3] * (n // 3), np.int32)
    params = mat_jax.MaterialParams(plastic=True, **LAME)
    present = (0, 2, 3)
    update = jax.jit(mat_jax.plastic_update, static_argnums=(0, 4))
    f_j, jp_j = update(params, jnp.asarray(material), jnp.asarray(f), jnp.asarray(jp), present)
    params_t = mat.MaterialParams(plastic=True, **LAME)
    f_t, jp_t = mat.plastic_update(params_t, torch.from_numpy(material), torch.from_numpy(f),
                                   torch.from_numpy(jp), present)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(jp_t.numpy(), np.asarray(jp_j), rtol=0, atol=1e-12)
    assert not np.allclose(np.asarray(f_j), f)     # the clamp acted
    # The static no-op: no clamping material, F and Jp returned as they are.
    f_in, jp_in = torch.from_numpy(f), torch.from_numpy(jp)
    same = mat.plastic_update(mat.MaterialParams(), torch.from_numpy(material), f_in, jp_in, (0,))
    assert same[0] is f_in and same[1] is jp_in


@pytest.mark.parametrize("what,item", [
    ("csf", "item 6"), ("projection", "item 6"), ("snow", "item 4"), ("sand", "item 4"),
])
def test_unported_switches_raise(what, item):
    """The switches ROADMAP queue 1 items 6 (CSF, the projection) and 4
    (snow, sand) ported run on the general path: one substep, finite, the
    material's id kept (tests/test_torch_projection.py, _surface_tension.py,
    _snow.py and _sand.py hold them to JAX)."""
    p, scene, _ = _jax_case("apic_bspline")
    p_t, scene_t = _to_port(p, scene)
    if what == "csf":
        scene_t = dataclasses.replace(
            scene_t, cfg=dataclasses.replace(scene_t.cfg, surface_tension=0.07))
    elif what == "projection":
        scene_t = dataclasses.replace(
            scene_t, cfg=dataclasses.replace(scene_t.cfg, incompressible=True))
    else:
        mid = mat.SNOW if what == "snow" else mat.SAND
        p_t = dataclasses.replace(p_t, material=torch.full_like(p_t.material, mid))
        scene_t = dataclasses.replace(scene_t, materials_present=(mid,),
                                      params=dataclasses.replace(scene_t.params, **LAME))
    got = stabilized.run(p_t, scene_t, 1)
    assert all(bool(torch.isfinite(t).all()) for t in (got.x, got.v, got.F, got.Jp))
    assert torch.equal(got.material, p_t.material)
