"""The port's general path in bfloat16 against the JAX package's bf16 mode.

The JAX package runs its general path on bfloat16 particles
(tests/test_dtypes.py).  XLA's CPU arithmetic there, which the port keeps:

  scatter     `.at[].add` rounds each node's sum to bf16 after every add, in
              update order (not `index_add_`'s float32 sum rounded once):
              `scatter.sequential_add_bf16`, the kernel's bf16 mode on the card;
  products    `einsum(..., precision="highest")` (`mathx.mm`, `mv`, the
              stencil contractions): float32 products summed in float32 in
              order, rounded once (`mathx.dot_sum`); the three-operand D
              einsum rounds w * dpos first;
  sums        `jnp.sum`: float32 in order, rounded once (`mathx.seq_sum`);
  constants   a Python float meeting a bf16 array is rounded to bf16 first
              (weak typing; `config.Bf16`), float64 -> float32 -> bf16.

Held here (numpy-seeded states carried across with `convert`):
  - the bf16 plain scatters against `.at[].add`, bitwise, a dense node too,
    and the gather on 8- and 16-byte bf16 rows;
  - one substep against JAX's eager bf16 substep: every field bitwise, on
    tests/test_dtypes.py's 37^2 dam, the stabilized set with APIC, the snow
    block and the 3D dam at 16^3;
  - 5 substeps from a thrown state whose positions move: every field bitwise;
  - JAX's jitted `run` (its fori_loop): every field bitwise after 50
    substeps but `pou`, which XLA's fusion computes from float32 weight
    products (the product rounding that the eager substep does is fused
    away): within 1 bf16 ulp of 1, its scale;
  - JAX's own bf16 contract (tests/test_dtypes.py:44-66) on the port.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.ops import transfer as transfer_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import stabilized
from mpm_flip98a_tpu_torch.ops import weights
from mpm_flip98a_tpu_torch.ops.cuda import scatter

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_dtypes.py:14
STAB_APIC = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
BF16_ULP_AT_1 = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_bf16(p):
    """JAX Particles with every float32 field cast to bf16 (test_dtypes.py:30-37)."""
    return type(p)(**{f: (getattr(p, f).astype(jnp.bfloat16)
                          if getattr(p, f).dtype == jnp.float32 else getattr(p, f))
                      for f in p.__dataclass_fields__})


def _port(p):
    return convert.particles_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p.__dataclass_fields__}, "cpu")


def _scene(scene):
    return convert.scene_from_fields(dataclasses.asdict(scene))


def _bits(a) -> np.ndarray:
    """The bit patterns of a bf16 tensor or array (other dtypes as they are)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _differ(pj, pt, skip=()):
    """Fields of JAX `pj` and port `pt` whose bits differ."""
    return [f for f in pj.__dataclass_fields__
            if f not in skip and not np.array_equal(_bits(getattr(pj, f)), _bits(getattr(pt, f)))]


def _thrown(p, seed, scale):
    """p (JAX, bf16) with seeded velocities of about `scale` m/s."""
    rng = np.random.default_rng(seed)
    v = scale * rng.standard_normal(np.asarray(p.v).shape)
    return dataclasses.replace(p, v=jnp.asarray(v, jnp.float32).astype(jnp.bfloat16))


# ---------------------------------------------------------------------------
# The scatter
# ---------------------------------------------------------------------------

def _rows(rng, shape, c):
    vals = rng.standard_normal(shape + (c,)) * 10.0 ** rng.uniform(-3, 3, shape + (1,))
    vals[rng.random(shape) < 0.1] = 0.0
    return np.where(rng.random(shape + (c,)) < 0.05, -0.0, vals).astype(np.float32)


@pytest.mark.parametrize("case", ["one_tap_dense", "stencil2d", "stencil2d_dense", "stencil3d"])
def test_bf16_plain_scatter_is_jax_at_add(case):
    """`scatter_add_plain` / `stencil_add_plain` on bf16 rows bitwise JAX's
    bf16 `.at[].add` (transfer.p2g_scatter, stabilized._scatter_cells):
    each node's sum rounded after every add in row order, with rows of +-0
    and taps past the walls; a dense node takes 2,000 rows.  `index_add_`
    (float32 sums rounded once) is not that function."""
    rng = np.random.default_rng(len(case))
    if case == "one_tap_dense":
        nodes, m = 50, 6000
        flat = rng.integers(0, nodes, m)
        flat[rng.choice(m, 2000, replace=False)] = 7
        vals = _rows(rng, (m,), 3)
        vj = jnp.asarray(vals).astype(jnp.bfloat16)
        want = jnp.zeros((nodes, 3), jnp.bfloat16).at[jnp.asarray(flat)].add(vj)
        vt, ft = torch.from_numpy(vals).bfloat16(), torch.from_numpy(flat)
        got = scatter.scatter_add(vt, ft, nodes)
        index_add = torch.zeros((nodes, 3), dtype=torch.bfloat16).index_add_(0, ft, vt)
        assert not np.array_equal(_bits(index_add), _bits(want))
    else:
        d = 3 if case == "stencil3d" else 2
        shape = (12,) * 3 if d == 3 else (30, 30)
        n = 3000
        base = np.stack([rng.integers(-3, g + 1, n) for g in shape], axis=1)
        if case.endswith("dense"):
            base[rng.choice(n, 2000, replace=False)] = np.asarray(shape) // 2
        vals = _rows(rng, (n, 3**d), 5)
        offsets = weights.stencil_offsets(d)
        want = transfer_jax.p2g_scatter(jnp.asarray(vals).astype(jnp.bfloat16),
                                        jnp.asarray(base, jnp.int32), offsets, shape)
        got = scatter.stencil_add(torch.from_numpy(vals).bfloat16(), torch.from_numpy(base),
                                  offsets, shape)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got).reshape(-1), _bits(want).reshape(-1))


@pytest.mark.parametrize("c", [4, 8])
def test_bf16_gather_is_jax_gather(c):
    """`transfer.g2p_gather` on a bf16 grid bitwise JAX's: 4 channels (8-byte
    rows, the row gather) and 8 (16-byte rows, the element gather), taps
    past the walls zeroed."""
    from mpm_flip98a_tpu_torch.ops import transfer

    rng = np.random.default_rng(c)
    shape = (20, 20)
    grid = rng.standard_normal(shape + (c,)).astype(np.float32)
    base = np.stack([rng.integers(-2, g + 1, 500) for g in shape], axis=1)
    offsets = weights.stencil_offsets(2)
    want = transfer_jax.g2p_gather(jnp.asarray(grid).astype(jnp.bfloat16),
                                   jnp.asarray(base, jnp.int32), offsets)
    got = transfer.g2p_gather(torch.from_numpy(grid).bfloat16(), torch.from_numpy(base),
                              offsets)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# One substep, several substeps, the jitted run
# ---------------------------------------------------------------------------

def _case(name):
    """(JAX bf16 particles, JAX scene) of a named one-substep case."""
    if name == "dam37":
        p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST), dtype=np.float32)
        return _to_bf16(p), scene
    if name == "stab_apic":
        p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST, **STAB_APIC), dtype=jnp.bfloat16)
        return _thrown(p, 1, 1.0), scene
    if name == "snow":
        p, scene = scenes_jax.snow_block_2d(MPMConfig(**FAST), dtype=jnp.bfloat16,
                                            particles_per_axis=16)
        return _thrown(p, 2, 1.0), scene
    p, scene = scenes_jax.dam_break_3d(16, (8, 8, 16), dtype=jnp.bfloat16)
    return _thrown(p, 3, 1.0), scene


@pytest.mark.parametrize("name", ["dam37", "stab_apic", "snow", "dam3d16"])
def test_bf16_substep_bitwise_jax(name):
    """One bf16 substep of the port bitwise JAX's eager bf16 substep on every
    field (each scatter by the sequential rounded sum, each contraction in
    float32 rounded once, each constant rounded to bf16)."""
    pj, scene = _case(name)
    want = stab_jax.substep(pj, scene)
    got = stabilized.substep(_port(pj), _scene(scene))
    assert got.x.dtype == torch.bfloat16
    assert not _differ(want, got)


def test_bf16_moving_substeps_bitwise_jax():
    """Five bf16 substeps of the stabilized FLIP set at dt 1e-4 from a state
    thrown at about 6 m/s, whose positions move (over 40% of them change
    bits; at test_dtypes.py's dt 2e-5 from rest x + dt v rounds back to x):
    every field bitwise after each substep."""
    cfg = MPMConfig(**dict(FAST, dt=1e-4), use_fbar=True, pressure_mixing_ratio=1.0,
                    use_penalty_ebc=True, flip_blend=0.98, transfer=TransferKind.PIC)
    p, scene = scenes_jax.dam_break_2d(cfg, dtype=jnp.bfloat16)
    pj, sc = _thrown(p, 4, 6.0), _scene(scene)
    pt = _port(pj)
    x0 = _bits(pt.x).copy()
    for _ in range(5):
        pj, pt = stab_jax.substep(pj, scene), stabilized.substep(pt, sc)
        assert not _differ(pj, pt)
    assert (_bits(pt.x) != x0).any(axis=1).mean() > 0.4


def test_bf16_jitted_run_against_port():
    """JAX's jitted `run` (tests/test_dtypes.py:26-41's 50 bf16 substeps)
    against the port's: every field bitwise but `pou`, a diagnostic no
    later substep reads, which XLA's fused reduce sums from float32 weight
    products; it stays within 1 bf16 ulp of its scale, 1."""
    p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST), dtype=np.float32)
    pj = _to_bf16(p)
    want = stab_jax.run(pj, scene, 50)
    got = stabilized.run(_port(pj), _scene(scene), 50)
    assert not _differ(want, got, skip=("pou",))
    pou_err = np.abs(np.asarray(want.pou, np.float32) - got.pou.float().numpy()).max()
    assert pou_err <= BF16_ULP_AT_1


def test_bf16_jax_contract_on_the_port():
    """tests/test_dtypes.py's bf16 contract held by the port: 50 bf16
    substeps finite and inside the box; one bf16 substep against float32
    from the same particles, |dx| < 4e-3 and |dv| < 0.05 max(|v32|, 1)."""
    p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST), dtype=np.float32)
    p32, sc = _port(p), _scene(scene)
    p16 = dataclasses.replace(p32, **{f.name: getattr(p32, f.name).bfloat16()
                                      for f in dataclasses.fields(p32)
                                      if getattr(p32, f.name).dtype == torch.float32})
    out = stabilized.run(p16, sc, 50)
    x = out.x.float()
    assert out.x.dtype == torch.bfloat16 and torch.isfinite(x).all()
    assert (x > -4 * sc.cfg.dx).all() and (x < sc.cfg.domain_length + 4 * sc.cfg.dx).all()
    o32, o16 = stabilized.substep(p32, sc), stabilized.substep(p16, sc)
    assert float((o16.x.float() - o32.x).abs().max()) < 4e-3
    v_scale = max(float(o32.v.abs().max()), 1.0)
    assert float((o16.v.float() - o32.v).abs().max()) < 0.05 * v_scale
