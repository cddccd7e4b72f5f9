"""The port's prepped 3D path against the JAX package, slice as a whole.

3D configs outside "one fluid, no F-bar or mixing, B-spline" prep their
stress in torch and go through `p2g3d_grid`'s prepped mode (absolute mass
floor) or `p2g3d` + `fold_rows0` + `_grid_update` (relative floor), then
the gather-mode `g2p3d` (fast3d.py:646-934).  Both packages start from the
same bucketed state (built by the JAX package and carried across with
`convert`); one substep is compared against JAX `fast3d.substep` from a
perturbed state (random v, C, F, J and lagged averages, so every stress
term and the lag correction act), at the JAX fast path's tolerances
(tests/test_fast2d.py:56-57: 1e-7 on x, 1e-4 on v) or tighter, stated per
case.  The JAX kernels run in Pallas interpret mode (seconds per call at
16^3); the port runs its plain versions.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import EOSKind, KernelKind, TransferKind
from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu_torch import convert, driver
from mpm_flip98a_tpu_torch.config import KernelKind as KernelKind_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast3d, scenes
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

SMALL = dict(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, dtype=np.float32)
FLIP = dict(flip_blend=0.98, transfer=TransferKind.PIC)
STAB = dict(FLIP, use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
VARIANTS = {   # name: (config switches, scene kind, (x atol, v atol))
    "fbar_mix05": (dict(use_fbar=True, pressure_mixing_ratio=0.5), "dam", (1e-8, 1e-6)),
    "stabilized": (STAB, "dam", (1e-8, 1e-6)),
    "tent": (dict(FLIP, kernel=KernelKind.TENT), "dam", (1e-8, 1e-6)),
    "tait_fbar": (dict(FLIP, use_fbar=True), "tait", (1e-8, 1e-6)),
    "drop_neo_hookean": (dict(), "drop_neo", (1e-8, 1e-6)),
    "drop_corotated": (dict(FLIP), "drop_corot", (1e-8, 1e-6)),
    "relative_floor": (STAB, "relfloor", (1e-8, 1e-6)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(variant):
    switches, kind, _ = VARIANTS[variant]
    if kind.startswith("drop"):
        material = mat_jax.NEO_HOOKEAN if kind == "drop_neo" else mat_jax.FIXED_COROTATED
        return scenes_jax.elastic_drop_3d(block_material=material, **switches)
    p, scene = scenes_jax.dam_break_3d(**SMALL, **switches)
    if kind == "tait":
        scene = dataclasses.replace(
            scene, params=dataclasses.replace(scene.params, eos=EOSKind.TAIT))
    elif kind == "relfloor":
        scene = dataclasses.replace(scene, mass_floor=0.0)
    return p, scene


C_NAMES = [f"C{a}{c}" for a in range(3) for c in range(3)]
F_NAMES = [f"F{a}{c}" for a in range(3) for c in range(3)]


def _perturbed(fields, seed):
    """Random live-slot state: v, C, F = I + noise, J and the lagged
    averages.  Dead slots keep their neutral values."""
    rng = np.random.default_rng(seed)
    on = fields["mask"] > 0
    out = dict(fields)

    def put(name, val):
        out[name] = np.where(on, val, fields[name]).astype(np.float32)

    for name in ("v0", "v1", "v2"):
        put(name, rng.normal(0.0, 0.2, on.shape))
    for name in C_NAMES:
        put(name, rng.normal(0.0, 20.0, on.shape))
    for i, name in enumerate(F_NAMES):
        put(name, (1.0 if i % 4 == 0 else 0.0) + rng.normal(0.0, 0.03, on.shape))
    put("J", 1.0 + rng.normal(0.0, 0.01, on.shape))
    put("jbar_s", 1.0 + rng.normal(0.0, 0.01, on.shape))
    put("p_s", rng.normal(0.0, 2e3, on.shape))
    put("div_s", rng.normal(0.0, 5.0, on.shape))
    return out


def _np_fields(b):
    return {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}


@functools.lru_cache(maxsize=None)
def _states(variant, perturb=True):
    """(JAX scene, spec, buckets) and the port's (scene, spec, buckets) in
    the same layout, cached per variant for the tests that share them."""
    p, scene = _jax_scene(variant)
    spec = fast3d_jax.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d_jax.from_particles(p, scene.cfg, spec)
    fields = _np_fields(b)
    if perturb:
        fields = _perturbed(fields, seed=len(variant))
        b = dataclasses.replace(
            b, **{n: jnp.asarray(a) for n, a in fields.items() if n != "overflow"})
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast3d.FastSpec3D(spec.rows0, spec.rows1, spec.capacity)
    return (scene, spec, b), (scene_t, spec_t, convert.buckets3d_from_numpy(fields, device="cpu"))


def _np(b, name):
    a = getattr(b, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_single_substep_matches_jax(variant):
    (scene, spec, b), (scene_t, spec_t, b_t) = _states(variant)
    x_atol, v_atol = VARIANTS[variant][2]
    assert not fast3d.uses_fused(scene_t)
    b1 = fast3d_jax.substep(b, scene, spec)
    b1_t = fast3d.substep(b_t, scene_t, spec_t)
    np.testing.assert_array_equal(_np(b1_t, "mask"), _np(b1, "mask"))
    for a in range(3):
        np.testing.assert_allclose(_np(b1_t, f"x{a}"), _np(b1, f"x{a}"), rtol=0, atol=x_atol)
        np.testing.assert_allclose(_np(b1_t, f"v{a}"), _np(b1, f"v{a}"), rtol=0, atol=v_atol)
    # State the next substep reads: J, F and the gathered averages, within
    # 1e-5 of each field's max deviation from rest (the sums' rounding)
    # plus 1e-6 of the value (a few float32 ulps of J and Jbar near 1).
    rests = [("J", 1.0), ("jbar_s", 1.0), ("p_s", 0.0), ("div_s", 0.0), ("C01", 0.0),
             ("C22", 0.0), ("F00", 1.0), ("F12", 0.0), ("F21", 0.0)]
    for name, rest in rests:
        want = _np(b1, name)
        dev = float(np.abs(want - rest).max())
        np.testing.assert_allclose(_np(b1_t, name), want, rtol=1e-6, atol=1e-5 * dev,
                                   err_msg=name)
    for name in ("mass", "vol0", "Jp"):
        np.testing.assert_array_equal(_np(b1_t, name), _np(b1, name))
    assert sum(tk3.LAUNCHES.values()) == 0   # the CPU runs the plain versions


def test_stabilized_run_across_a_rebucket_tracks_jax():
    """25 substeps of the stabilized switch set with the column set 1.5
    cells off the walls (their penalty band would hold it back) and thrown
    along both bucketed axes, 0.06 and 0.04 cells per substep, so the
    margin check fires a rebucket on the way: JAX `fast3d.run` and the
    port rebucket at the same substeps and stay in the same slot layout."""
    kw = dict(SMALL, dt=2e-4)
    p, scene = scenes_jax.dam_break_3d(**kw, **STAB)
    v = np.zeros((p.n, 3), np.float32)
    v[:, 0], v[:, 1], v[:, 2] = 12.0, 8.0, -1.0
    off = np.float32(1.5 * scene.cfg.dx)
    p = dataclasses.replace(p, v=p.v.at[:].set(v), x=p.x.at[:, :2].add(off))
    spec = fast3d_jax.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d_jax.from_particles(p, scene.cfg, spec)
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast3d.FastSpec3D(spec.rows0, spec.rows1, spec.capacity)
    stats = fast3d.RunStats()
    b_t = convert.buckets3d_from_numpy(_np_fields(b), device="cpu")
    out_t = fast3d.run(b_t, scene_t, spec_t, 25, stats)
    out = fast3d_jax.run(b, scene, spec, 25)
    assert stats.rebuckets >= 1 and stats.substeps == 25
    np.testing.assert_array_equal(_np(out_t, "mask"), _np(out, "mask"))
    for a in range(3):
        np.testing.assert_allclose(_np(out_t, f"x{a}"), _np(out, f"x{a}"), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(out_t, f"v{a}"), _np(out, f"v{a}"), rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(out_t, "jbar_s"), _np(out, "jbar_s"), rtol=0, atol=1e-5)
    assert int(out.overflow) == int(out_t.overflow) == 0


ROUTES = {   # variant: the P2G wrapper its substep calls
    "stabilized": "p2g3d_grid", "tent": "p2g3d_grid", "drop_neo_hookean": "p2g3d_grid",
    "relative_floor": "p2g3d",
}


@pytest.mark.parametrize("variant", list(ROUTES))
def test_routing_follows_the_reference(variant):
    """fast3d.py:586-591 and :786-811: the prepped branch takes
    `p2g3d_grid` (prepped planes, `ext` / `tent` as configured) with an
    absolute mass floor and `p2g3d` without one; G2P runs in gather mode."""
    _, (scene_t, spec_t, b_t) = _states(variant, perturb=False)
    cfg = scene_t.cfg
    ext = bool(cfg.use_fbar or cfg.pressure_mixing_ratio > 0)
    apic = cfg.transfer == TransferKind_t.APIC
    with mock.patch.object(tk3, "p2g3d", wraps=tk3.p2g3d) as p2g3d, \
            mock.patch.object(tk3, "p2g3d_grid", wraps=tk3.p2g3d_grid) as p2g3d_grid, \
            mock.patch.object(tk3, "g2p3d", wraps=tk3.g2p3d) as g2p3d:
        fast3d.substep(b_t, scene_t, spec_t)
    called, other = (p2g3d, p2g3d_grid) if ROUTES[variant] == "p2g3d" else (p2g3d_grid, p2g3d)
    assert called.call_count == 1 and other.call_count == 0 and g2p3d.call_count == 1
    fields = called.call_args.args[0]
    kw = called.call_args.kwargs
    assert len(fields) == tk3.n_prepped(apic, ext)
    assert kw["ext"] == ext and kw["tent"] == (variant == "tent") and kw.get("stress") is None
    assert ("floor" in kw) == (ROUTES[variant] == "p2g3d_grid")
    assert g2p3d.call_args.kwargs["tent"] == (variant == "tent")
    grid = g2p3d.call_args.args[5]
    padded = ROUTES[variant] == "p2g3d_grid"
    assert grid.shape[:3] == (16 + 4 * padded, 16 + 4 * padded, 9 if ext else 6)


def test_fused_predicate_and_relative_floor_fallback():
    """`uses_fused` is fast3d.py:586-591's predicate.  The fused kernels
    take the absolute mass floor only and the port has no fallback for a
    `uses_fused` scene without one (the reference sends it to
    `p2g3d_grid`'s raw mode, fast3d.py:631-645): it raises, while the same
    scene with F-bar, off the fused branch, takes `p2g3d`."""
    p, scene = scenes.dam_break_3d(**SMALL, flip_blend=0.98, transfer=TransferKind_t.PIC)
    assert fast3d.uses_fused(scene)
    fbar = dataclasses.replace(scene.cfg, use_fbar=True)
    assert not fast3d.uses_fused(dataclasses.replace(scene, cfg=fbar))
    assert not fast3d.uses_fused(dataclasses.replace(
        scene, cfg=dataclasses.replace(scene.cfg, pressure_mixing_ratio=0.5)))
    assert not fast3d.uses_fused(dataclasses.replace(
        scene, cfg=dataclasses.replace(scene.cfg, kernel=KernelKind_t.TENT)))
    assert not fast3d.uses_fused(dataclasses.replace(scene, materials_present=(0, 1)))
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d.from_particles(p, scene.cfg, spec, device="cpu")
    assert "stress" in fast3d.p2g_args(scene)
    rel = dataclasses.replace(scene, mass_floor=0.0)
    assert fast3d.uses_fused(rel)
    with mock.patch.object(tk3, "p2g3d", wraps=tk3.p2g3d) as p2g3d, \
            mock.patch.object(tk3, "p2g3d_grid", wraps=tk3.p2g3d_grid) as p2g3d_grid:
        with pytest.raises(NotImplementedError, match="relative mass floor.*ROADMAP"):
            fast3d.run(b, rel, spec, 1)
        assert p2g3d.call_count == p2g3d_grid.call_count == 0
        rel_fbar = dataclasses.replace(rel, cfg=fbar)
        assert "stress" not in fast3d.p2g_args(rel_fbar)
        fast3d.run(b, rel_fbar, spec, 2)
        assert p2g3d.call_count == 2 and p2g3d_grid.call_count == 0


@pytest.mark.parametrize("block", ["neo_hookean", "corotated"])
def test_elastic_drop_3d_matches_jax(block):
    """Each package builds the scene itself: same bits (per-particle
    volume, density and material through `Particles.init`), same scene."""
    material = mat_jax.NEO_HOOKEAN if block == "neo_hookean" else mat_jax.FIXED_COROTATED
    kw = dict(num_grids=16, fluid_particles=(9, 8, 4), block_particles=(4, 5, 3),
              block_material=material, flip_blend=0.98)
    p_j, scene_j = scenes_jax.elastic_drop_3d(transfer=TransferKind.PIC, **kw)
    p_t, scene_t = scenes.elastic_drop_3d(transfer=TransferKind_t.PIC, **kw)
    assert p_t.n == 9 * 8 * 4 + 4 * 5 * 3
    for f in dataclasses.fields(p_j):
        want = np.asarray(getattr(p_j, f.name))
        got = getattr(p_t, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))
    assert scene_t.materials_present == (0, material) and scene_t.cfg.dim == 3


def test_stresses_at_finite_strain_match_jax_materials():
    """The port's matrix-form 3D stresses and the component form the fast
    path preps (`fast3d._stress`, with `_polar3d_rows`) against JAX
    `materials` at a finite strain, within 1e-6 of the stress scale."""
    _, scene = _jax_scene("drop_neo_hookean")
    params = dataclasses.replace(scene.params, lam=3e4)   # log J and J - 1 differ visibly
    f = np.array([[1.15, 0.05, -0.02], [-0.03, 0.9, 0.04], [0.02, -0.06, 1.05]], np.float32)
    rng = np.random.default_rng(0)
    n = 6
    fs = (f[None] + rng.normal(0.0, 0.02, (n, 3, 3))).astype(np.float32)
    vol0 = rng.uniform(1e-5, 2e-5, n).astype(np.float32)
    material = np.array([0, 1, 2, 1, 2, 0], np.int32)
    j = rng.uniform(0.97, 1.03, n).astype(np.float32)
    c = rng.normal(0.0, 20.0, (n, 3, 3)).astype(np.float32)
    strain = 0.5 * (c + c.transpose(0, 2, 1))
    pressure = (-params.bulk_modulus * (j - 1.0)).astype(np.float32)
    present = (0, 1, 2)
    ja = jnp.asarray
    want = {
        "neo": np.asarray(mat_jax.neo_hookean_tau_hat(params, ja(vol0), ja(fs))),
        "corot": np.asarray(mat_jax.fixed_corotated_tau_hat(params, ja(vol0), ja(fs))),
        "mixed": np.asarray(mat_jax.tau_hat(
            params, ja(material), ja(vol0), ja(fs), ja(j), ja(pressure), ja(strain), present)),
    }
    params_t = convert.scene_from_fields(
        dataclasses.asdict(dataclasses.replace(scene, params=params))).params
    t = torch.from_numpy
    got = {
        "neo": mat.neo_hookean_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "corot": mat.fixed_corotated_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "mixed": mat.tau_hat(params_t, t(material), t(vol0), t(fs), t(j), t(pressure),
                             t(strain), present).numpy(),
    }
    # The fast path's component form on a one-pencil bucket of the same slots.
    ones, zeros = np.ones((1, n), np.float32), np.zeros((1, n), np.float32)
    fields = {name: zeros for name in (
        "x0", "x1", "x2", "v0", "v1", "v2", "mass", "p_s", "div_s")}
    fields.update({f"C{a}{e}": c[None, :, a, e] for a in range(3) for e in range(3)})
    fields.update({f"F{a}{e}": fs[None, :, a, e] for a in range(3) for e in range(3)})
    fields.update(J=j[None], jbar_s=j[None], vol0=vol0[None], mat=material[None], Jp=ones,
                  mask=ones, overflow=np.zeros((), np.int32))
    scene_fast = dataclasses.replace(
        convert.scene_from_fields(dataclasses.asdict(scene)), params=params_t,
        materials_present=present)
    tau, p_point, _ = fast3d._stress(convert.buckets3d_from_numpy(fields, device="cpu"), scene_fast)
    got["fast3d"] = torch.stack(tau, -1).reshape(n, 3, 3).numpy()
    want["fast3d"] = want["mixed"]
    for key in want:
        scale = float(np.abs(want[key]).max())
        assert scale > 0
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale, err_msg=key)
    np.testing.assert_allclose(p_point.numpy()[0], pressure, rtol=1e-6)
    assert np.abs(want["neo"] - want["corot"]).max() > 1e-2 * np.abs(want["neo"]).max()
    # The component-form polar: a rotation, and F = R S with S symmetric.
    r = torch.stack(fast3d._polar3d_rows([t(fs[:, a, e]) for a in range(3) for e in range(3)]),
                    -1).reshape(n, 3, 3).numpy().astype(np.float64)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    s = r.transpose(0, 2, 1) @ fs
    np.testing.assert_allclose(s, s.transpose(0, 2, 1), atol=1e-6)


@pytest.mark.parametrize("scene_kind", ["stabilized", "elastic_drop_3d"])
def test_simulation_runs_the_prepped_3d_branch(tmp_path, scene_kind):
    """`driver.Simulation` built from (particles, scene) routes by
    `cfg.dim` and runs the stabilized switch set and `elastic_drop_3d`,
    frames and VTK included."""
    if scene_kind == "stabilized":
        p, scene = scenes.dam_break_3d(
            num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, flip_blend=0.98,
            transfer=TransferKind_t.PIC, use_fbar=True, use_penalty_ebc=True,
            pressure_mixing_ratio=1.0)
    else:
        p, scene = scenes.elastic_drop_3d()
    sim = driver.Simulation(p, scene, path="fast", out_dir=str(tmp_path), device="cpu",
                            render_res=64)
    sim.run(2, 3, gif=False, verbose=False)
    assert sim.stats.substeps == 6
    h = fast3d.to_host(sim.state)
    assert h["x0"].shape == (p.n,) and all(np.isfinite(h[n]).all() for n in h)
    assert np.abs(h["J"] - 1.0).max() < 0.1
    np.testing.assert_allclose(h["mass"].sum(), float(p.mass.sum()), rtol=1e-6)
    import os

    assert len(os.listdir(sim.frame_dir)) == 2 and len(os.listdir(sim.vtk_dir)) == 2
