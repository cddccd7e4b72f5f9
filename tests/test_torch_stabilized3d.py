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

The module keeps the variants that share JAX's compiled kernels (the
B-spline ext grid and gather of the dam at 16^3: F-bar with mixing, the
stabilized set, Tait with F-bar), the routing, and two cases of
tests/test_torch_p2g3d.py: the extended grid with the penalty wall and its
padded gather, which is the gather program the F-bar substeps compile, so
the two share one compile here.  tests/test_torch_stabilized3d_tent_relfloor.py
holds the tent dam and the relative floor (with the driver's `Simulation`
runs), tests/test_torch_stabilized3d_drop.py the elastic drops (with the
stresses at finite strain) and tests/test_torch_fast3d_rebucket.py the
run across a rebucket: each of their JAX compiles serves no case here, and
no file outgrows its share of the suite's time.
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
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import KernelKind as KernelKind_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast3d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

from test_torch_p2g3d import check_g2p3d_gather, check_p2g3d_grid_prepped

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


# The variants of tests/test_torch_stabilized3d_tent_relfloor.py and _drop.py.
TENT_RELFLOOR = ("tent", "relative_floor")
DROP = ("drop_neo_hookean", "drop_corotated")


def check_single_substep(variant):
    """One substep of `variant` from its perturbed state, the port against
    JAX `fast3d.substep` (called eagerly: the variants that share a kernel
    configuration then share its compile)."""
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


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v not in TENT_RELFLOOR + DROP])
def test_single_substep_matches_jax(variant):
    check_single_substep(variant)


# tests/test_torch_p2g3d.py's cases whose JAX gather an F-bar substep above
# has compiled: the same `g2p3d` arguments, so the same jit cache entry.
@pytest.mark.parametrize("case", ["ext_penalty"])
def test_p2g3d_grid_prepped_matches_jax(case):
    check_p2g3d_grid_prepped(case)


@pytest.mark.parametrize("case", ["ext_padded"])
def test_g2p3d_gather_matches_jax(case):
    check_g2p3d_gather(case)


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
