"""The port's rigid SDF colliders in 3D against the JAX package.

`p2g3d_grid`'s collider mode at the kernel boundary (the JAX kernel in
Pallas interpret mode at 16^3; the port's wrapper runs its plain version
on the CPU: the CUDA node pass is held to that plain version on the card
in tests/test_torch_cuda.py): a static sphere and a moving sphere at
`tcol` in the stress mode, a sticky moving box and a halfspace spinner in
the prepped 11-channel mode.  Then the 3D path over 5 substeps against JAX
`fast3d.run`: tests/test_colliders.py's static scene on the fused branch
here; its kinematic scene (with the kernel's collider arguments) in
tests/test_torch_colliders3d_kinematic.py, the kinematic one on the
relative-floor route (colliders in torch `_grid_update`) in
tests/test_torch_colliders3d_relfloor.py, and the kinematic scene in 2
slab shards against one device in tests/test_torch_colliders_sharded.py,
on this module's scenes, states and checks.  Each JAX run is a compile of
its own (30-60 s on the CPU), so the three files hold one each and stay
inside their share of the suite's time.
Tolerances: the finished grid to 1e-6 of each channel's max (fp32 sums in
another order); runs slot for slot, x to 1e-6, v to 1e-5 of max |v|, J to
1e-6.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.models import colliders as col_jax
from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.ops.pallas import transfer3d as tk3_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import colliders as col
from mpm_flip98a_tpu_torch.models import fast3d
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

R, K, G = 16, 128, 16
DX = 0.4375 / 11
DT = 2e-5
REL = 1e-6
# JAX's bucketing as one program: called eagerly it compiles each of its
# operations on its own, seconds a scene.
from_particles_jax = jax.jit(fast3d_jax.from_particles, static_argnames=("cfg", "spec"))
NODE = dict(dt=DT, grav=(0.0, 0.0, -9.81), floor=1e-8, lo=2, hi=G - 3, wall="slip", beta=0.0)
STRESS = dict(kb=2e6, mu=1e-3, gamma=7.0, fa=-DT * 4.0 / DX**2)
SPIN_N = (0.15, -0.1, 1.0)
# name: (mode, colliders (Collider fields), tcol)
CASES = {
    "stress_static_sphere": ("tait_apic", [
        dict(kind="sphere", center=(0.25, 0.3, 0.22), radius=0.13)], None),
    "stress_moving_sphere": ("linear_pic", [
        dict(kind="sphere", center=(0.3, 0.2, 0.05), radius=0.12,
             center_velocity=(0.2, 0.5, 1.5))], 0.1),
    "ext_box_and_spinner": ("pic11", [
        dict(kind="box", center=(0.2, 0.35, 0.3), half_extents=(0.1, 0.12, 0.07), sticky=True,
             velocity=(0.5, 0.0, -0.3), center_velocity=(0.0, -0.4, 0.0)),
        dict(kind="halfspace", center=(0.0, 0.0, 0.12), normal=SPIN_N,
             angular=tuple(6.0 * c / np.linalg.norm(SPIN_N) for c in SPIN_N))], 0.1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed=4):
    """Random pencil slots: empty, partly filled and full pencils, slots
    outside the +-1 margin, slots on the axis-1 edges (their taps land in
    the pad rows), z past both grid edges.  Returns the 18 state planes
    and the prepped 11-channel PIC planes (numpy f32) and the counts."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, (R, R))
    counts[0, :3] = 0
    counts[5, 5] = K
    counts[:, 0] = counts[:, R - 1] = K // 2
    rel0 = rng.choice([-1, 0, 0, 0, 1, 2], size=(R, R, K))
    rel1 = rng.choice([-1, 0, 0, 0, 1, -2], size=(R, R, K))
    gx0 = np.arange(R)[:, None, None] + rel0 + 0.5 + rng.random((R, R, K))
    gx1 = np.arange(R)[None, :, None] + rel1 + 0.5 + rng.random((R, R, K))
    gx2 = rng.uniform(-1.0, G + 1.0, (R, R, K))
    live = np.arange(K) < counts[..., None]
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, R, K)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (R, R, K)), 0.0)
    v = [rng.normal(0.0, 1.0, (R, R, K)) for _ in range(3)]
    c = [rng.normal(0.0, 5.0, (R, R, K)) for _ in range(9)]
    j = np.where(live, rng.uniform(0.98, 1.02, (R, R, K)), 1.0)
    f32 = lambda a: np.asarray(a, np.float32)
    state = [f32(a) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0)]
    prepped = [f32(a) for a in (
        gx0, gx1, gx2, *(mass * a for a in v), *(live * rng.normal(0.0, 5.0, (R, R, K))
                                                 for _ in range(9)),
        mass, vol0 * j, vol0, vol0 * rng.normal(0.0, 2e3, (R, R, K)),
        vol0 * rng.normal(0.0, 5.0, (R, R, K)))]
    return state, prepped, counts.reshape(-1).astype(np.int32)


STATE, PREPPED, COUNTS = _slots()


def _mode(mode):
    """(planes, kernel keyword arguments) of a mode."""
    if mode == "pic11":
        return PREPPED, dict(apic=False, ext=True)
    eos, transfer = mode.split("_")
    return STATE, dict(apic=transfer == "apic", stress=eos, **STRESS)


@functools.lru_cache(maxsize=None)
def _jax_grid(case):
    mode, fields, tcol = CASES[case]
    planes, kw = _mode(mode)
    return np.asarray(tk3_jax.p2g3d_grid(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(COUNTS), R, G, DX, **kw, **NODE,
        colliders=tuple(col_jax.Collider(**f) for f in fields),
        tcol=None if tcol is None else jnp.float32(tcol)))


def _port_grid(case, colliders=True):
    mode, fields, tcol = CASES[case]
    planes, kw = _mode(mode)
    cols = tuple(col.Collider(**f) for f in fields) if colliders else ()
    return tk3.p2g3d_grid(tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(COUNTS),
                          R, G, DX, **kw, **NODE, colliders=cols, tcol=tcol).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_p2g3d_grid_colliders_match_jax(case):
    want = _jax_grid(case)
    got = _port_grid(case)
    free = _port_grid(case, colliders=False)
    nch = want.shape[2]
    assert got.shape == want.shape == (R + 4, R + 4, nch, G)
    for ch in range(nch):
        scale = max(float(np.abs(want[:, :, ch]).max()), 1e-30)
        err = float(np.abs(got[:, :, ch].astype(np.float64) - want[:, :, ch]).max())
        assert err <= REL * scale, (ch, err, scale)
    # The colliders act on the interior; the axis-0 pad rows stay zero, and
    # the axis-1 pad rows keep the walls' result (transfer3d.py:567-570).
    assert np.abs(got[1 : R + 1, 1 : R + 1, :3] - free[1 : R + 1, 1 : R + 1, :3]).max() > 0.1
    assert not got[0].any() and not got[R + 1 :].any() and not want[0].any()
    pads = [0, R + 1, R + 2, R + 3]
    np.testing.assert_array_equal(got[:, pads], free[:, pads])
    assert np.abs(free[1 : R + 1, pads, :3]).max() > 0
    np.testing.assert_array_equal(got[:, :, 3:6], free[:, :, 3:6])   # v_old untouched
    assert tk3.LAUNCHES["p2g3d_grid"] == 0


# ---------------------------------------------------------------------------
# The 3D path
# ---------------------------------------------------------------------------


def _scene(kind):
    """tests/test_colliders.py:557-567 (static) and :589-601 (kinematic,
    t0 = 0.01); "relfloor": the kinematic one with F-bar and mass_floor 0,
    which takes p2g3d + fold_rows0 + `_grid_update`."""
    p, scene = scenes_jax.slab_3d(num_grids=16, particles_per_axis=(10, 10, 6), dt=2e-5,
                                  height_frac=0.35)
    l = scene.cfg.domain_length
    if kind == "static":
        sphere = col_jax.Collider(kind="sphere", center=(0.5 * l, 0.5 * l, 0.05 * l),
                                  radius=0.12 * l)
    else:
        sphere = col_jax.Collider(kind="sphere", center=(0.5 * l, 0.5 * l, -0.10 * l),
                                  radius=0.12 * l, center_velocity=(0.0, 0.0, 2.0))
    scene = dataclasses.replace(scene, colliders=(sphere,))
    if kind == "relfloor":
        scene = dataclasses.replace(scene, mass_floor=0.0,
                                    cfg=dataclasses.replace(scene.cfg, use_fbar=True))
    return p, scene, None if kind == "static" else 0.01


@functools.lru_cache(maxsize=None)
def _states(kind):
    p, scene, t0 = _scene(kind)
    spec = fast3d_jax.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = from_particles_jax(p, scene.cfg, spec)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast3d.FastSpec3D(spec.rows0, spec.rows1, spec.capacity)
    b_t = convert.buckets3d_from_numpy(fields, device="cpu")
    return (p, scene, spec, b, t0), (scene_t, spec_t, b_t)


def _assert_tracks(got, want, what):
    g = {f.name: np.asarray(getattr(got, f.name)) for f in dataclasses.fields(got)}
    w = {f.name: np.asarray(getattr(want, f.name)) for f in dataclasses.fields(want)}
    np.testing.assert_array_equal(g["mask"], w["mask"])
    v_scale = max(float(np.abs(w[f"v{a}"]).max()) for a in range(3))
    for a in range(3):
        np.testing.assert_allclose(g[f"x{a}"], w[f"x{a}"], rtol=0, atol=1e-6, err_msg=what)
        np.testing.assert_allclose(g[f"v{a}"], w[f"v{a}"], rtol=0, atol=1e-5 * v_scale,
                                   err_msg=what)
    np.testing.assert_allclose(g["J"], w["J"], rtol=0, atol=1e-6, err_msg=what)


def check_3d_run(kind):
    """JAX `fast3d.run` and the port over 5 substeps of scene `kind`, slot
    for slot; the same run without the sphere leaves the tolerance."""
    (_, scene, spec, b, t0), (scene_t, spec_t, b_t) = _states(kind)
    assert fast3d.uses_fused(scene_t) == (kind != "relfloor")
    want = fast3d_jax.run(b, scene, spec, 5, t0)
    got = fast3d.run(b_t, scene_t, spec_t, 5, t0=t0)
    _assert_tracks(got, want, kind)
    # The sphere acts: the same run without it leaves the tolerance.
    free = fast3d.run(b_t, dataclasses.replace(scene_t, colliders=()), spec_t, 5)
    with pytest.raises(AssertionError):
        _assert_tracks(free, want, kind)


@pytest.mark.parametrize("kind", ["static"])
def test_3d_run_matches_jax(kind):
    check_3d_run(kind)
