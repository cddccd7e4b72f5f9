"""The port's prepped-P2G 2D path against the JAX package, slice as a whole.

Configs outside "one fluid, no F-bar or mixing, B-spline" prep their
stress in torch and go through `p2g` and the extended / tent `g2p`
(fast2d.py:537-542).  Both packages start from the same bucketed state
(built by the JAX package and carried across with `convert`); one
substep is compared against JAX `fast2d.substep` from a perturbed state
(random v, C, F, J and lagged averages, so every stress term and the
lag correction act), at the JAX fast path's tolerances
(tests/test_fast2d.py:56-57).  The JAX kernels run in Pallas interpret
mode; the port runs its plain versions.

The elastic-drop block is neo-Hookean.  The port gives it the
neo-Hookean stress of `materials.neo_hookean_tau_hat`; the JAX
`fast2d` dispatch (fast2d.py:657-681) has lost its NEO_HOOKEAN branch
and gives it the corotated one (ROADMAP queue 3).  The two agree while
F = I, so the elastic drop is compared with JAX `fast2d` from rest only,
held to the JAX general path (`stabilized.run`) over 50 substeps, and
the stress itself is pinned at a finite strain.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models.stabilized import Scene as SceneJax
from mpm_flip98a_tpu.models.stabilized import run as run_general_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import MPMConfig as MPMConfig_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models import scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

_KW = dict(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)
FLIP = dict(flip_blend=0.98, transfer=TransferKind.PIC)
E_SOLID, NU_SOLID = 5e4, 0.3
VARIANTS = {   # name: (config switches, scene)
    "fbar_mix05": (dict(FLIP, use_fbar=True, pressure_mixing_ratio=0.5), "dam"),
    "stabilized": (dict(FLIP, use_fbar=True, use_penalty_ebc=True,
                        pressure_mixing_ratio=1.0), "dam"),
    "penalty": (dict(FLIP, use_penalty_ebc=True), "dam"),
    "tent": (dict(FLIP, kernel=KernelKind.TENT), "dam"),
    "tait_fbar": (dict(FLIP, use_fbar=True), "tait"),
    "corotated": (dict(transfer=TransferKind.APIC), "corotated"),
    "elastic_drop": (dict(FLIP, dt=1e-5), "drop"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(variant):
    switches, kind = VARIANTS[variant]
    cfg = MPMConfig(**{**_KW, **switches})
    if kind == "drop":
        return scenes_jax.elastic_drop_2d(cfg, dtype=np.float32)
    p, scene = scenes_jax.dam_break_2d(cfg, dtype=np.float32)
    if kind == "tait":
        scene = dataclasses.replace(
            scene, params=dataclasses.replace(scene.params, eos=EOSKind.TAIT))
    elif kind == "corotated":
        params = dataclasses.replace(
            scene.params, mu=E_SOLID / (2 * (1 + NU_SOLID)),
            lam=E_SOLID * NU_SOLID / ((1 + NU_SOLID) * (1 - 2 * NU_SOLID)))
        scene = SceneJax(cfg=cfg, physics=scene.physics, params=params,
                         materials_present=(mat_jax.FIXED_COROTATED,))
        p = dataclasses.replace(
            p, material=jnp.full_like(p.material, mat_jax.FIXED_COROTATED))
    return p, scene


def _perturbed(fields, seed, deform):
    """Random live-slot state: v, C, J and the lagged averages; F = I +
    noise when `deform`.  Dead slots keep their neutral values."""
    rng = np.random.default_rng(seed)
    on = fields["mask"] > 0
    out = dict(fields)

    def put(name, val):
        out[name] = np.where(on, val, fields[name]).astype(np.float32)

    for name in ("v0", "v1"):
        put(name, rng.normal(0.0, 0.2, on.shape))
    for name in ("C00", "C01", "C10", "C11"):
        put(name, rng.normal(0.0, 20.0, on.shape))
    put("J", 1.0 + rng.normal(0.0, 0.01, on.shape))
    put("jbar_s", 1.0 + rng.normal(0.0, 0.01, on.shape))
    put("p_s", rng.normal(0.0, 2e3, on.shape))
    put("div_s", rng.normal(0.0, 5.0, on.shape))
    if deform:
        for name, eye in (("F00", 1.0), ("F01", 0.0), ("F10", 0.0), ("F11", 1.0)):
            put(name, eye + rng.normal(0.0, 0.03, on.shape))
    return out


@functools.lru_cache(maxsize=None)
def _states(variant, perturb=True):
    """(JAX scene, spec, buckets) and the port's (scene, buckets) in the
    same layout, cached per variant for the tests that share them."""
    p, scene = _jax_scene(variant)
    spec = fast2d_jax.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = fast2d_jax.from_particles(p, scene.cfg, spec)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    if perturb:
        # The elastic drop stays at F = I (see the module docstring).
        fields = _perturbed(fields, seed=len(variant), deform=variant != "elastic_drop")
        b = dataclasses.replace(b, **{n: jnp.asarray(a) for n, a in fields.items()
                                      if n != "overflow"})
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    return (scene, spec, b), (scene_t, convert.buckets_from_numpy(fields, device="cpu"))


def _np(b, name):
    a = getattr(b, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_single_substep_matches_jax(variant):
    (scene, _, b), (scene_t, b_t) = _states(variant)
    # Penalty EBC alone keeps the fused P2G (fast2d.py:537-542); its new
    # part is the grid update.
    assert fast2d.uses_fused(scene_t) == (variant == "penalty")
    b1 = fast2d_jax.substep(b, scene)
    b1_t = fast2d.substep(b_t, scene_t)
    np.testing.assert_array_equal(_np(b1_t, "mask"), _np(b1, "mask"))
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(b1_t, name), _np(b1, name), atol=1e-7)
    for name in ("v0", "v1"):
        np.testing.assert_allclose(_np(b1_t, name), _np(b1, name), atol=1e-4)
    # State the next substep reads: J, F and the gathered averages, within
    # 1e-5 of each field's max deviation from rest (the sums' rounding)
    # plus 1e-6 of the value (a few float32 ulps of J and Jbar near 1).
    for name, rest in (("J", 1.0), ("F01", 0.0), ("jbar_s", 1.0), ("p_s", 0.0), ("div_s", 0.0)):
        want = _np(b1, name)
        dev = float(np.abs(want - rest).max())
        np.testing.assert_allclose(_np(b1_t, name), want, rtol=1e-6, atol=1e-5 * dev,
                                   err_msg=name)
    assert tk.LAUNCHES["p2g"] == tk.LAUNCHES["p2g_fused"] == 0


def test_fused_routing_follows_the_reference():
    """fast2d.py:537-542: only one fluid without F-bar, mixing or tent
    takes `p2g_fused`; penalty EBC alone keeps it."""
    _, (scene_t, _) = _states("penalty", perturb=False)
    assert fast2d.uses_fused(scene_t)
    assert set(fast2d.p2g_args(scene_t)) >= {"eos", "kb", "fa"}
    for variant in ("fbar_mix05", "tent", "corotated", "elastic_drop"):
        _, (scene_t, b_t) = _states(variant, perturb=False)
        assert not fast2d.uses_fused(scene_t)
        data, pdata2, counts = fast2d.transfer_inputs(b_t, scene_t)
        ext = scene_t.cfg.use_fbar or scene_t.cfg.pressure_mixing_ratio > 0
        assert data.shape[1] == (17 if ext else 14) and pdata2.shape[1] == 3
        assert fast2d.p2g_args(scene_t)["tent"] == (variant == "tent")


def _dense_xy(x0, x1, v0, v1):
    x = np.stack([x0, x1], axis=-1)
    v = np.stack([v0, v1], axis=-1)
    order = np.lexsort((x[:, 1], x[:, 0]))
    return x[order], v[order]


def test_hundred_substeps_fbar_mixing_track_jax():
    (scene, spec, b), (scene_t, b_t) = _states("fbar_mix05", perturb=False)
    out = fast2d_jax.run(b, scene, spec, 100)
    out_t = fast2d.run(b_t, scene_t, fast2d.FastSpec(spec.rows, spec.capacity), 100)
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(out_t, name), _np(out, name), atol=1e-5)
    assert int(out.overflow) == int(out_t.overflow) == 0


def test_elastic_drop_tracks_the_jax_general_path():
    """Each package builds the scene itself; the port's fast path against
    JAX `stabilized.run` (materials.tau_hat) at test_fast2d.py:97-98's
    tolerances."""
    switches, _ = VARIANTS["elastic_drop"]
    cfg = MPMConfig(**{**_KW, **switches})
    cfg_t = MPMConfig_t(**{**_KW, **switches, "transfer": TransferKind_t.PIC})
    p, scene = scenes_jax.elastic_drop_2d(cfg, dtype=np.float32)
    p_t, scene_t = scenes.elastic_drop_2d(cfg_t, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg_t, p_t, headroom=2.0)
    stats = fast2d.RunStats()
    out_t = fast2d.run(fast2d.from_particles(p_t, cfg_t, spec, device="cpu"), scene_t, spec, 50,
                       stats)
    ref = run_general_jax(p, scene, 50)
    h = fast2d.to_host(out_t)
    x_t, v_t = _dense_xy(h["x0"], h["x1"], h["v0"], h["v1"])
    x, v = _dense_xy(*np.asarray(ref.x).T, *np.asarray(ref.v).T)
    assert x_t.shape == x.shape == (p.n, 2)
    np.testing.assert_allclose(x_t, x, atol=1e-6)
    np.testing.assert_allclose(v_t, v, atol=1e-3)
    assert int(out_t.overflow) == 0 and stats.substeps == 50


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_elastic_drop_2d_matches_jax(dtype):
    """Each package builds the scene itself: same bits (per-particle
    volume, density and material through `Particles.init`), same scene."""
    p_j, scene_j = scenes_jax.elastic_drop_2d(MPMConfig(**{**_KW, **FLIP}), dtype=dtype)
    p_t, scene_t = scenes.elastic_drop_2d(
        MPMConfig_t(**{**_KW, **FLIP, "transfer": TransferKind_t.PIC}), dtype=dtype)
    assert p_t.n == 16 * 32 + 14 * 14
    for f in dataclasses.fields(p_j):
        want = np.asarray(getattr(p_j, f.name))
        got = getattr(p_t, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))


def test_stresses_at_finite_strain_match_jax_materials():
    """The port's matrix-form stresses and the component form the fast
    path preps (fast2d._stress) against JAX `materials` at a finite
    strain, within 1e-6 of the stress scale.  The neo-Hookean slots must
    get neo-Hookean stress (not fast2d.py's corotated fall-through)."""
    _, scene = _jax_scene("elastic_drop")
    params = dataclasses.replace(scene.params, lam=3e4)   # log J and J - 1 differ visibly
    f = np.array([[1.15, 0.05], [-0.03, 0.9]], np.float32)
    rng = np.random.default_rng(0)
    n = 6
    fs = (f[None] + rng.normal(0.0, 0.02, (n, 2, 2))).astype(np.float32)
    vol0 = rng.uniform(1e-5, 2e-5, n).astype(np.float32)
    material = np.array([0, 1, 2, 1, 2, 0], np.int32)
    j = rng.uniform(0.97, 1.03, n).astype(np.float32)
    c = rng.normal(0.0, 20.0, (n, 2, 2)).astype(np.float32)
    strain = 0.5 * (c + c.transpose(0, 2, 1))
    pressure = -params.bulk_modulus * (j - 1.0)
    present = (0, 1, 2)
    want = {
        "neo": np.asarray(mat_jax.neo_hookean_tau_hat(params, jnp.asarray(vol0), jnp.asarray(fs))),
        "corot": np.asarray(mat_jax.fixed_corotated_tau_hat(params, jnp.asarray(vol0), jnp.asarray(fs))),
        "mixed": np.asarray(mat_jax.tau_hat(
            params, jnp.asarray(material), jnp.asarray(vol0), jnp.asarray(fs), jnp.asarray(j),
            jnp.asarray(pressure), jnp.asarray(strain), present)),
    }
    params_t = convert.scene_from_fields(
        dataclasses.asdict(dataclasses.replace(scene, params=params))).params
    t = torch.from_numpy
    got = {
        "neo": mat.neo_hookean_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "corot": mat.fixed_corotated_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "mixed": mat.tau_hat(params_t, t(material), t(vol0), t(fs), t(j),
                             t(pressure.astype(np.float32)), t(strain), present).numpy(),
    }
    # The fast path's component form on a one-row bucket of the same slots.
    ones, zeros = np.ones((1, n), np.float32), np.zeros((1, n), np.float32)
    fields = {name: zeros for name in (
        "x0", "x1", "v0", "v1", "mass", "p_s", "div_s", "overflow")}
    fields.update(
        C00=c[None, :, 0, 0], C01=c[None, :, 0, 1], C10=c[None, :, 1, 0], C11=c[None, :, 1, 1],
        F00=fs[None, :, 0, 0], F01=fs[None, :, 0, 1], F10=fs[None, :, 1, 0],
        F11=fs[None, :, 1, 1], J=j[None], jbar_s=j[None], vol0=vol0[None],
        mat=material[None], Jp=ones, mask=ones, overflow=np.zeros((), np.int32),
    )
    scene_fast = dataclasses.replace(
        convert.scene_from_fields(dataclasses.asdict(scene)), params=params_t,
        materials_present=present)
    tau, _, _ = fast2d._stress(convert.buckets_from_numpy(fields, device="cpu"), scene_fast)
    got["fast2d"] = torch.stack(tau, -1).reshape(n, 2, 2).numpy()
    want["fast2d"] = want["mixed"]
    for key in want:
        scale = float(np.abs(want[key]).max())
        assert scale > 0
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale, err_msg=key)
    # The choice this pins: neo-Hookean and corotated differ here by far
    # more than the tolerance.
    assert np.abs(want["neo"] - want["corot"]).max() > 1e-2 * np.abs(want["neo"]).max()
