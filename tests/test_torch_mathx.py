"""`ops/mathx` of the port against the JAX module, function by function.

Seeded batches of 2x2 and 3x3 matrices: general ones near the identity
(MPM's deformation gradients), near-singular ones (smallest singular value
1e-4), reflected ones (det < 0) and ones with a repeated singular value.
Float64 within 1e-12 of each output's scale, float32 within 1e-6.

The SVD is compared up to what it defines.  A repeated singular value
leaves its vectors free (in 2D the closed form then picks them by the
rounding of S), so every case holds the singular values to JAX's and
U diag(sig) V^T to the input, and each singular vector to JAX's only where
its value is simple.  There the 2D vectors equal JAX's; the 3D ones agree
up to sign, as JAX diagonalises the polar factor with LAPACK's eigh and
the port with Jacobi sweeps.  (U diag(sig) V^T is held to the input, not
to JAX's product: in float32 JAX's own 3D factors rebuild the input only
to 8e-7 of scale, so two sound float32 factorizations can lie more than
1e-6 of scale apart.)
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops import mathx as mathx_jax
from mpm_flip98a_tpu_torch.ops import mathx

TOL = {np.float64: 1e-12, np.float32: 1e-6}
KINDS = ("general", "near_singular", "reflected", "repeated")
N = 64


def _rotations(rng, n, d):
    q, r = np.linalg.qr(rng.standard_normal((n, d, d)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1.0
    return q


@functools.lru_cache(maxsize=None)
def batch(kind, d, dtype):
    rng = np.random.default_rng(hash((kind, d)) % 2**32)
    if kind == "general":
        m = np.eye(d) + 0.3 * rng.standard_normal((N, d, d))
    else:
        sig = rng.uniform(0.5, 2.0, (N, d))
        if kind == "near_singular":
            sig[:, -1] = 1e-4
        elif kind == "repeated":
            sig[:, 1] = sig[:, 0]
        u, v = _rotations(rng, N, d), _rotations(rng, N, d)
        m = u @ (sig[..., None] * np.swapaxes(v, -1, -2))
        if kind == "reflected":
            m[:, :, 0] *= -1.0
    return m.astype(dtype)


def _close(got, want, dtype, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == dtype, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= TOL[dtype], f"{what}: {err:.3e} of scale {scale:.3e}"


FUNCS = ("mm", "mv", "det", "transpose", "polar_decomp", "inv", "solve", "outer", "trace",
         "eye_like")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", FUNCS)
def test_matches_jax(name, kind, d, dtype):
    m = batch(kind, d, dtype)
    m2 = batch("general", d, dtype)[::-1].copy()
    vec = m2[:, 0, :].copy()
    args = {
        "mm": (m, m2), "mv": (m, vec), "solve": (m, vec), "outer": (vec, m[:, 1, :]),
    }.get(name, (m,))
    want = getattr(mathx_jax, name)(*(jnp.asarray(a) for a in args))
    got = getattr(mathx, name)(*(torch.from_numpy(a) for a in args))
    if isinstance(want, tuple):
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, dtype, f"{name}[{k}]")
    else:
        _close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_svd_matches_jax(kind, d, dtype):
    """Singular values and U diag(sig) V^T everywhere; each singular
    vector whose singular value is simple (a gap above 1e-3): in 2D equal
    to JAX's (the same closed form), in 3D up to its sign."""
    m = batch(kind, d, dtype)
    u, sig, v = mathx.svd(torch.from_numpy(m))
    uj, sigj, vj = (np.asarray(a) for a in mathx_jax.svd(jnp.asarray(m)))
    _close(sig, sigj, dtype, "sig")
    rebuilt = mathx.mm(u, sig[..., :, None] * mathx.transpose(v))
    _close(rebuilt, m, dtype, "U sig V^T against m")
    gap = np.abs(np.diff(sigj.astype(np.float64), axis=-1))
    for k in range(d):
        near = np.stack([gap[:, j] for j in (k - 1, k) if 0 <= j < d - 1], -1).min(-1)
        simple = near > 1e-3
        if not simple.any():
            continue
        cond = max(1.0 / near[simple].min(), 1.0)
        for got, want in ((v, vj), (u, uj)):
            g = got.numpy()[simple, :, k].astype(np.float64)
            w = want[simple, :, k].astype(np.float64)
            sign = np.sign(np.sum(g * w, axis=-1))[:, None] if d == 3 else 1.0
            err = float(np.abs(sign * g - w).max())
            assert err <= TOL[dtype] * cond, f"vector {k}: {err:.3e}"


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_dispatch_keeps_dtype(dtype):
    m = torch.from_numpy(batch("general", 3, dtype))
    for fn in (mathx.det, mathx.trace, mathx.inv):
        assert fn(m).dtype == m.dtype
    assert all(t.dtype == m.dtype for t in mathx.svd(m) + mathx.polar_decomp(m))
