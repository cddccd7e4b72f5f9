"""Plasticity in the port against the JAX package: the material functions
and the corotated clamp (`MaterialParams.plastic`) on every path.

The material functions (`snow_tau_hat`, `sand_alpha`, `sand_tau_hat`,
`sand_return`, `plastic_update`, `tau_hat`) run on the same F from a seed,
as tests/test_sand.py:40-93 builds them: symmetric stretches exp(eps) in
random frames (compressed, stretched, past the tip), plus exact states at
and near the tip, pure compression, pure stretch and F = I.  Tolerances,
relative to each output's largest magnitude:

  float64  1e-12 against JAX
  float32  1e-6 against JAX where the SVD's rounding does not reach the
           output; else no further from the float64 value (the port's, on
           the same float32 input) than JAX's float32 result is, plus 1e-6.
           The sand stress takes log(sig) near 1, which magnifies the
           singular values' rounding, and the closed-form 2D SVD of both
           packages is up to 5 ulps off: JAX's own float32 sand stress is
           2.8e-6 (2D) and 4.5e-6 (3D) of scale off the float64 value.  A
           3D F rebuilt as U exp(eps) V^T carries the two SVDs' differing
           roundings of U and V (1.2e-6 of scale apart).

In 3D the port's SVD agrees with JAX's up to the sign of each singular
vector pair (ops/mathx.py), so U diag(sig) V^T, the singular values, the
Hencky strain and the returned F are compared, not U and V.  An elastic
state leaves F bitwise unchanged (`sand_return`'s `changed` mask).

The corotated clamp runs the cases of tests/test_plasticity.py (a tight
clamp band so the drop engages it): the 2D drop through the port's fast
and general paths against the JAX general path (x within 1e-7 after 1
substep, 1e-5 after 100), and the pre-strained 3D drop at 16^3 (1 and 20
substeps).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.ops import mathx as mathx_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, materials as mat, stabilized
from mpm_flip98a_tpu_torch.ops import mathx

LAME = dict(mu=1.0e5, lam=1.5e5, friction_angle=30.0)   # tests/test_sand.py:23
TOL = {np.float64: 1e-12, np.float32: 1e-6}
LO, HI = 1.0 - 5e-3, 1.0 + 1e-3                          # tests/test_plasticity.py:34
X_TOL = {1: 1e-7, 20: 1e-5, 100: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs(d):
    """(F, V0, Jp, material) in float64: 256 random stretches exp(eps),
    eps ~ N(0, 0.05), in random frames U diag V^T, then special states."""
    rng = np.random.default_rng(10 + d)
    n = 256
    eps = rng.normal(scale=0.05, size=(n, d))
    u, _ = np.linalg.qr(rng.normal(size=(n, d, d)))
    v, _ = np.linalg.qr(rng.normal(size=(n, d, d)))
    f = (u * np.exp(eps)[:, None, :]) @ np.swapaxes(v, -1, -2)
    special = [np.zeros(d), np.full(d, -0.03), np.full(d, 0.02),    # I, compressed, stretched
               np.r_[0.04, -0.04, np.zeros(d - 2)],                 # on the tip, tr = 0
               np.r_[0.04 + 1e-7, -0.04, np.zeros(d - 2)],          # just past it
               np.r_[0.04 - 1e-7, -0.04, np.zeros(d - 2)]]          # just inside
    f = np.concatenate([f, np.stack([np.diag(np.exp(e)) for e in special])])
    m = f.shape[0]
    return (f, rng.uniform(1e-6, 2e-6, m), rng.uniform(0.7, 1.3, m),
            np.array([0, 2, 3, 4] * (m // 4) + [4] * (m % 4), np.int32))


def _both(fn_name, d, dtype, present=(mat.SAND,)):
    """(JAX result, port result, float64 port result) of one function."""
    f, v0, jp, material = _inputs(d)
    pj, pt = mat_jax.MaterialParams(plastic=True, **LAME), mat.MaterialParams(plastic=True, **LAME)

    def call(mod, params, arr, cast):
        a = lambda x: arr(x.astype(cast) if x.dtype != np.int32 else x)
        if fn_name == "sand_tau_hat":
            return mod.sand_tau_hat(params, a(v0), a(f))
        if fn_name == "snow_tau_hat":
            return mod.snow_tau_hat(params, a(v0), a(f), a(jp))
        if fn_name == "sand_return":
            return mod.sand_return(params, a(f))
        if fn_name == "plastic_update":
            return mod.plastic_update(params, a(material), a(f), a(jp), present)
        z = np.zeros_like(v0)
        return mod.tau_hat(params, a(material), a(v0), a(f), a(z + 1.0), a(z),
                           a(np.zeros_like(f)), present, jp=a(jp))

    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)
    want = [np.asarray(r) for r in as_tuple(call(mat_jax, pj, jnp.asarray, dtype))]
    got = [r.numpy() for r in as_tuple(call(mat, pt, torch.from_numpy, dtype))]
    exact = [r.numpy() for r in as_tuple(call(mat, pt, torch.from_numpy, np.float64))]
    return want, got, exact


FUNCTIONS = [("sand_tau_hat", (4,)), ("snow_tau_hat", (3,)), ("sand_return", (4,)),
             ("plastic_update", (4,)), ("plastic_update", (0, 4)), ("plastic_update", (0, 2, 3, 4)),
             ("plastic_update", (3,)), ("tau_hat", (0, 2, 3, 4)), ("tau_hat", (4,))]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("fn,present", FUNCTIONS,
                         ids=[f"{f}-{''.join(map(str, p))}" for f, p in FUNCTIONS])
def test_material_functions_match_jax(fn, present, d, dtype):
    want, got, exact = _both(fn, d, dtype, present)
    for w, g, e in zip(want, got, exact):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(np.abs(w).max())
        err = float(np.abs(g.astype(np.float64) - w).max()) / scale
        if err <= TOL[dtype]:
            continue
        assert dtype == np.float32, err
        ref = float(np.abs(w.astype(np.float64) - e).max()) / scale
        own = float(np.abs(g.astype(np.float64) - e).max()) / scale
        assert own <= ref + TOL[dtype], (err, own, ref)


def test_sand_alpha_matches_jax():
    for phi in (15.0, 30.0, 35.0, 45.0):
        assert mat.sand_alpha(mat.MaterialParams(friction_angle=phi)) == \
            mat_jax.sand_alpha(mat_jax.MaterialParams(friction_angle=phi))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_svd3d_and_hencky_match_jax(dtype):
    """The port's Jacobi SVD against JAX's eigh-based one on the 3D inputs:
    sig and the Hencky strain within TOL; U diag(sig) V^T as close to F
    as JAX's is, plus TOL (float32: JAX's is 1.1e-6 off F, the port's
    3.0e-7)."""
    f = _inputs(3)[0].astype(dtype)
    u, sig, v = (r.numpy() for r in mathx.svd(torch.from_numpy(f)))
    uj, sj, vj = (np.asarray(r) for r in mathx_jax.svd(jnp.asarray(f)))
    recon = lambda a, s, b: (a * s[:, None, :]) @ np.swapaxes(b, -1, -2)
    off = np.abs(recon(u, sig, v) - f).max()
    assert off <= np.abs(recon(uj, sj, vj) - f).max() + TOL[dtype], off
    np.testing.assert_allclose(sig, sj, rtol=0, atol=TOL[dtype])
    eps_t = mat._hencky(torch.from_numpy(f))[3].numpy()
    eps_j = np.asarray(mat_jax._hencky(jnp.asarray(f))[3])
    np.testing.assert_allclose(eps_t, eps_j, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3])
def test_sand_return_keeps_elastic_f_bitwise(d, dtype):
    """Elastic states (inside the cone, tr eps <= 0) come back bitwise; the
    same states are elastic in both packages."""
    f = _inputs(d)[0].astype(dtype)
    params = mat.MaterialParams(**LAME)
    got = mat.sand_return(params, torch.from_numpy(f)).numpy()
    want = np.asarray(mat_jax.sand_return(mat_jax.MaterialParams(**LAME), jnp.asarray(f)))
    same_t, same_j = (got == f).all(axis=(-2, -1)), (want == f).all(axis=(-2, -1))
    np.testing.assert_array_equal(same_t, same_j)
    assert 0.1 < same_t.mean() < 0.9 and same_t[len(same_t) - 6]      # F = I is elastic


@pytest.mark.parametrize("d", [2, 3])
def test_return_mapping_cases(d):
    """tests/test_sand.py:40-93 on the port (float64): projected states land
    on the cone with their volume kept; past the tip eps = 0."""
    f = _inputs(d)[0]
    params = mat.MaterialParams(**LAME)
    eps = mat._hencky(torch.from_numpy(f))[3].numpy()
    eps_after = mat._hencky(mat.sand_return(params, torch.from_numpy(f)))[3].numpy()

    def yield_value(e):
        tr = e.sum(-1)
        dev = e - tr[..., None] / d
        mu, lam = LAME["mu"], LAME["lam"]
        return np.sqrt((dev * dev).sum(-1)) + mat.sand_alpha(params) * (
            d * lam + 2 * mu) / (2 * mu) * tr

    tip = eps.sum(-1) > 0
    plastic = ~tip & (yield_value(eps) > 0)
    assert tip.any() and plastic.any() and (~tip & ~plastic).any()
    np.testing.assert_allclose(eps_after[tip], 0.0, atol=1e-9)
    np.testing.assert_allclose(yield_value(eps_after[plastic]), 0.0, atol=1e-6)
    np.testing.assert_allclose(eps_after[plastic].sum(-1), eps[plastic].sum(-1), atol=1e-9)


# ---- the corotated clamp on every path ------------------------------------

CFG2 = MPMConfig(dtype="float32", num_grids=37, dt=4e-5, num_particles_x=16,   # :24-32
                 num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC)


def _drop2d():
    """tests/test_plasticity.py:37-60: a corotated block just above the
    floor at -1 m/s with the tight clamp."""
    p, scene = scenes_jax.elastic_drop_2d(CFG2, dtype=np.float32,
                                          block_material=mat_jax.FIXED_COROTATED,
                                          plastic=True, drop_height_frac=0.02)
    v = jnp.where((p.material == mat_jax.FIXED_COROTATED)[:, None],
                  jnp.asarray([0.0, -1.0], p.v.dtype), 0.0)
    return dataclasses.replace(p, v=v), dataclasses.replace(
        scene, params=dataclasses.replace(scene.params, sig_clamp_lo=LO, sig_clamp_hi=HI))


def _drop3d():
    """tests/test_plasticity.py:97-116: the 3D drop, its block pre-strained
    to F = diag(1.02, 1, 0.97) so the clamp engages at once."""
    p, scene = scenes_jax.elastic_drop_3d(block_material=mat_jax.FIXED_COROTATED, plastic=True)
    scene = dataclasses.replace(
        scene, params=dataclasses.replace(scene.params, sig_clamp_lo=LO, sig_clamp_hi=HI))
    stretch = jnp.asarray(np.diag([1.02, 1.0, 0.97]), p.F.dtype)
    f0 = jnp.where((p.material == mat_jax.FIXED_COROTATED)[:, None, None], stretch[None], p.F)
    return dataclasses.replace(p, F=f0), scene


CASES = {"drop2d": _drop2d, "drop3d": _drop3d}
HORIZONS = [("drop2d", 1), ("drop2d", 100), ("drop3d", 1), ("drop3d", 20)]


@functools.lru_cache(maxsize=None)
def jax_general(case, n):
    """JAX's general path after n substeps: `stabilized.run` one substep a
    call, so that a case's horizons share one compile (as
    tests/test_torch_general2d.py's `jax_run` does)."""
    if n > 1:
        p, scene, q = jax_general(case, 1)
        for _ in range(1, n):
            q = stab_jax.run(q, scene, 1)
        return p, scene, q
    p, scene = CASES[case]()
    return p, scene, stab_jax.run(p, scene, 1)


def _to_port(p, scene):
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    return p_t, convert.scene_from_fields(dataclasses.asdict(scene))


def _block_sigma(f, material):
    sig = mathx.svd(torch.as_tensor(f))[1].numpy()
    return sig[np.asarray(material) == mat.FIXED_COROTATED]


@pytest.mark.parametrize("case,n", HORIZONS)
def test_fast_path_clamps_and_tracks_jax_general(case, n):
    p, scene, want = jax_general(case, n)
    p_t, scene_t = _to_port(p, scene)
    d = scene_t.cfg.dim
    mod = fast3d if d == 3 else fast2d
    spec = (fast3d.FastSpec3D if d == 3 else fast2d.FastSpec).for_particles(
        scene_t.cfg, p_t, headroom=2.0)
    b = mod.from_particles(p_t, scene_t.cfg, spec, "cpu")
    # Each live slot carries its particle index in p_s (unread without F-bar).
    ids = mod.from_particles(dataclasses.replace(p_t, Jp=torch.arange(p_t.n, dtype=torch.float32)),
                             scene_t.cfg, spec, "cpu").Jp
    out = mod.run(dataclasses.replace(b, p_s=torch.where(b.mask > 0, ids, 0.0)), scene_t, spec, n)
    assert int(out.overflow) == 0
    live = out.mask > 0
    slot = out.p_s[live].long().numpy()
    x = np.empty((p_t.n, d), np.float32)
    x[slot] = np.stack([getattr(out, f"x{a}")[live].numpy() for a in range(d)], -1)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=0, atol=X_TOL[n])
    f = torch.stack([torch.stack([getattr(out, f"F{a}{c}")[live] for c in range(d)], -1)
                     for a in range(d)], -2)
    s = _block_sigma(f, out.mat[live].numpy())
    assert np.isfinite(s).all() and s.min() >= LO - 1e-5 and s.max() <= HI + 1e-5
    if n > 1 or d == 3:                                   # the clamp engaged
        assert s.min() <= LO + 1e-4 or s.max() >= HI - 1e-4


@pytest.mark.parametrize("case,n", HORIZONS)
def test_general_path_clamps_and_tracks_jax_general(case, n):
    p, scene, want = jax_general(case, n)
    p_t, scene_t = _to_port(p, scene)
    got = stabilized.run(p_t, scene_t, n)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=X_TOL[n])
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=0, atol=1e-5)
    s = _block_sigma(got.F, got.material)
    assert s.min() >= LO - 1e-5 and s.max() <= HI + 1e-5
