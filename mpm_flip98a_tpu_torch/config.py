"""Configuration for the PyTorch/CUDA port of the MPM framework.

The same parameter surface as `mpm_flip98a_tpu/config.py` (itself a
mirror of the reference's ``config.py:4-46``): physical constants, the
feature switches and the derived grid geometry, as frozen dataclasses.
The only change is `torch_dtype` in place of the JAX `jnp_dtype`.
`MLS88Config` configures the C++ validation solver (`models/mls_mpm.py`).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np
import torch


def round_bf16(v) -> float:
    """v rounded to bfloat16 as JAX rounds a Python constant that meets a
    bfloat16 array: to float32 first, then to the nearest even bfloat16."""
    f = np.float32(v)
    if not np.isfinite(f):
        return float(f)
    u = int(f.view(np.uint32))
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(u).view(np.float32))


class Bf16(float):
    """A Python float that holds a bfloat16 value and rounds every
    arithmetic result to bfloat16, as JAX's 0-d bfloat16 arrays do (one
    rounding an operation; a plain float operand is rounded first, as a
    weak-typed constant is).  `np_float(torch.bfloat16)`."""

    def __new__(cls, v=0.0):
        return float.__new__(cls, round_bf16(float(v)))

    def _op(self, other, fn):
        if not isinstance(other, (int, float)) or isinstance(other, bool):
            return NotImplemented
        return Bf16(fn(float(self), float(Bf16(other))))

    def __add__(self, o): return self._op(o, lambda a, b: a + b)
    def __radd__(self, o): return self._op(o, lambda a, b: b + a)
    def __sub__(self, o): return self._op(o, lambda a, b: a - b)
    def __rsub__(self, o): return self._op(o, lambda a, b: b - a)
    def __mul__(self, o): return self._op(o, lambda a, b: a * b)
    def __rmul__(self, o): return self._op(o, lambda a, b: b * a)
    def __truediv__(self, o): return self._op(o, lambda a, b: a / b)
    def __rtruediv__(self, o): return self._op(o, lambda a, b: b / a)
    def __neg__(self): return Bf16(-float(self))
    def __pos__(self): return self
    def __abs__(self): return Bf16(abs(float(self)))


def np_float(dtype: torch.dtype):
    """The scalar type of a torch float dtype: numpy's float64 or float32,
    and `Bf16` for bfloat16.  A Python constant rounded through it meets a
    tensor of that dtype as JAX's `jnp.asarray(c, dtype)` does, and
    arithmetic among such scalars rounds as JAX's 0-d arrays of that dtype
    do, without a tensor made on the host."""
    if dtype == torch.bfloat16:
        return Bf16
    return np.float64 if dtype == torch.float64 else np.float32


def scalar(v, dtype: torch.dtype) -> float:
    """The Python constant v rounded to `dtype`, as a Python float."""
    return float(np_float(dtype)(v))


class TransferKind(str, enum.Enum):
    """Velocity transfer scheme (reference: config.py:18 ``switch_vt_I_APIC``)."""

    PIC = "pic"
    APIC = "apic"


class KernelKind(str, enum.Enum):
    """Interpolation kernel (reference: config.py:21 ``switch_kernelFunction``).

    ``BSPLINE`` is the quadratic B-spline (support 1.5 dx); ``TENT`` is the
    linear hat on the same 3-node stencil.
    """

    BSPLINE = "bspline"
    TENT = "tent"


class EOSKind(str, enum.Enum):
    """Equation of state for the weakly-compressible fluid pressure."""

    LINEAR = "linear"  # p = -K (J - 1)
    TAIT = "tait"      # p = (K/gamma) ((1/J)^gamma - 1), gamma = 7


@dataclasses.dataclass(frozen=True)
class Physics:
    """Physical constants of the fluid (reference: config.py:4-12).

    E = 2K(1 - nu), G = K(1 - nu)/(1 + nu) (config.py:9-10).
    """

    dynamic_viscosity: float = 1e-3     # [Pa s]     config.py:6
    poissons_ratio: float = 4.999e-1    # unitless   config.py:7
    bulk_modulus: float = 2e6           # [Pa]       config.py:8
    particle_density: float = 997.5     # [kg/m^3]   config.py:11
    gravity: float = -9.81              # [m/s^2]    config.py:12

    @property
    def youngs_modulus(self) -> float:  # config.py:9
        return self.bulk_modulus * 2.0 * (1.0 - self.poissons_ratio)

    @property
    def shear_modulus(self) -> float:  # config.py:10
        return self.bulk_modulus * (1.0 - self.poissons_ratio) / (1.0 + self.poissons_ratio)

    def lame_parameters(self) -> Tuple[float, float]:
        """(mu, lam) from (E, nu), as in mls-mpm88-explained.cpp:25-26."""
        e, nu = self.youngs_modulus, self.poissons_ratio
        mu = e / (2.0 * (1.0 + nu))
        lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return mu, lam


@dataclasses.dataclass(frozen=True)
class MPMConfig:
    """Numerical settings (reference: config.py:15-46)."""

    # -- discretisation -------------------------------------------------
    dim: int = 2                                  # config.py:22
    dtype: str = "float64"                        # config.py:17 (ti.f64)
    num_grids: int = 105                          # nodes per axis, config.py:37
    domain_length: float = 0.4375                 # [m] config.py:33
    dt: float = 1e-6                              # [s] config.py:26
    simulation_time: float = 3.0                  # [s] config.py:24
    frame_rate: float = 1e-2                      # [s] per frame, config.py:46

    # -- feature switches ----------------------------------------------
    transfer: TransferKind = TransferKind.APIC    # config.py:18
    kernel: KernelKind = KernelKind.BSPLINE       # config.py:21
    use_fbar: bool = False                        # config.py:19
    use_penalty_ebc: bool = False                 # config.py:20
    flip_blend: float = 0.0                       # alpha: 1=FLIP, 0=APIC/PIC, config.py:29
    pressure_mixing_ratio: float = 0.0            # 1=mixed, 0=pointwise, config.py:28
    eos: EOSKind = EOSKind.LINEAR
    # Extensions beyond the reference switch set: CSF surface tension
    # (models/stabilized._csf_force) and the incompressible projection
    # (models/projection.py), with its CG iteration cap and relative
    # residual exit.
    surface_tension: float = 0.0
    incompressible: bool = False
    pressure_iters: int = 60
    pressure_tol: float = 1e-4

    # -- penalty essential BCs ------------------------------------------
    penalty: float = 1e6                          # config.py:27

    # -- scene: dam-break fluid column ----------------------------------
    num_particles_x: int = 65                     # config.py:30
    num_particles_y: int = 130                    # config.py:31
    fluid_width: float = 0.057                    # [m] config.py:34
    fluid_height: float = 0.114                   # [m] config.py:35

    # -- kernel geometry ------------------------------------------------
    kernel_support_normalized: float = 1.5        # config.py:41

    numerical_tolerance: float = 1e-15            # config.py:23

    def __post_init__(self):
        # FLIP blending must pair with the PIC (non-affine) scatter: the
        # FLIP delta re-adds the local velocity field that the APIC affine
        # term already carried to the grid, double-counting it.
        if self.flip_blend > 0.0 and self.transfer == TransferKind.APIC:
            raise ValueError(
                "flip_blend > 0 requires transfer=TransferKind.PIC: the "
                "FLIP delta blend double-counts the APIC affine velocity "
                "field and diverges (pair alpha=0 with APIC instead)"
            )

    # ---- derived quantities (reference: config.py:32-46) --------------

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_particles(self) -> int:               # config.py:32
        return self.num_particles_x * self.num_particles_y

    @property
    def num_cells(self) -> int:                   # config.py:38
        return self.num_grids - 1

    @property
    def dx(self) -> float:
        """Grid spacing; 4 cells pad outside the physical domain (config.py:39)."""
        return self.domain_length / float(self.num_cells - 4)

    @property
    def inv_dx(self) -> float:                    # config.py:40
        return 1.0 / self.dx

    @property
    def kernel_support(self) -> float:            # config.py:42
        return self.kernel_support_normalized * self.dx

    @property
    def nodes_in_support_1d(self) -> int:         # config.py:43
        return int(self.kernel_support * self.inv_dx * 2 + self.numerical_tolerance)

    @property
    def grid_node_shift(self) -> float:           # config.py:44
        return float(self.kernel_support_normalized - 1.0)

    @property
    def initial_particle_volume(self) -> float:   # config.py:36
        return (self.fluid_width * self.fluid_height) / self.num_particles

    def penalty_parameter(self, physics: Physics) -> float:  # config.py:45
        return self.penalty * physics.particle_density * self.dx ** 2

    @property
    def substeps_per_frame(self) -> int:          # exec.py:21
        return int(self.frame_rate // self.dt)

    @property
    def num_frames(self) -> int:                  # exec.py:20
        return int(math.ceil(self.simulation_time / self.frame_rate))

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.num_grids,) * self.dim

    @property
    def stencil_size(self) -> int:
        """Nodes touched per particle: 3^dim for the quadratic B-spline."""
        return 3 ** self.dim

    def gravity_force(self, physics: Physics) -> Tuple[float, ...]:
        """Total gravity force on the fluid column (config.py:52)."""
        f = self.fluid_width * self.fluid_height * physics.particle_density * physics.gravity
        return (0.0,) * (self.dim - 1) + (f,)

    def gravity_acceleration(self, physics: Physics) -> Tuple[float, ...]:
        return (0.0,) * (self.dim - 1) + (physics.gravity,)


@dataclasses.dataclass(frozen=True)
class MLS88Config:
    """Configuration of the C++ validation solver
    (reference: cpp_validation/mls-mpm88-explained.cpp:8-26): fixed
    corotated with snow plasticity, the per-substep ground truth of the
    tests."""

    num_grid: int = 80            # cells per axis (nodes = num_grid + 1), :9
    dt: float = 1e-4              # :11
    frame_dt: float = 1e-3        # :12
    mass_p: float = 1.0           # :17
    vol_p: float = 1.0            # :18
    hardening: float = 1.0        # :19
    youngs_modulus: float = 1e2   # :20
    poissons_ratio: float = 0.499 # :21
    plastic: bool = True          # :22
    gravity: float = -200.0       # :113
    boundary: float = 0.05        # :116
    dim: int = 2

    @property
    def dx(self) -> float:        # :13
        return 1.0 / self.num_grid

    @property
    def inv_dx(self) -> float:    # :14
        return 1.0 * self.num_grid

    @property
    def mu_0(self) -> float:      # :25
        return self.youngs_modulus / (2.0 * (1.0 + self.poissons_ratio))

    @property
    def lambda_0(self) -> float:  # :26
        e, nu = self.youngs_modulus, self.poissons_ratio
        return e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def num_nodes(self) -> int:
        return self.num_grid + 1

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.num_nodes,) * self.dim
