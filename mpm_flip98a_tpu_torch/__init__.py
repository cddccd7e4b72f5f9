"""mpm_flip98a_tpu_torch — the PyTorch/CUDA port of `mpm_flip98a_tpu`.

The JAX package stays the reference; this package follows its module
layout and names, imports neither JAX nor the JAX package, and runs on an
NVIDIA H100 the general path (the stabilized solver in plain torch, the
default) and the fast path (the 2D and 3D dam breaks, the elastic drops,
the 3D slab; on one device or as N slab shards of it) through seven
hand-written CUDA kernels:

- `config`, `state`           — configuration, particle and grid state
- `models`                    — materials, scene, scene builders, the
                                general solver (`models/stabilized.py`),
                                the fast 2D and 3D solvers
                                (`models/fast2d.py`, `models/fast3d.py`),
                                the MLS-MPM88 validation model
                                (`models/mls_mpm.py`)
- `ops`                       — small-matrix algebra (`mathx`), stencil
                                weights, the general path's scatter and
                                gather (`transfer`), row and pencil
                                binning; `ops/cuda/transfer2d.py` and
                                `transfer3d.py` wrap the P2G / G2P kernels
                                in `csrc/`
- `parallel`                  — the slab-sharded fast path (`--devices N`):
                                `SlabMesh` (n shards as a leading tensor
                                dimension), `fast_domain`, `fast_domain3d`;
                                the general path's `domain` (slab
                                decomposition) and `replicated` (a psum-
                                merged grid) on `RankMesh`, one shard per
                                rank of a `torch.distributed` group that
                                `launch.run_ranks` starts
- `utils`                     — progress, timing, diagnostics, frame and
                                VTK output
- `driver`                    — the frame loop and CLI
- `convert`                   — JAX-package state (as numpy) into this
                                package's types, for the comparison tests
- `dryrun`                    — every multi-device strategy on tiny shapes
- `_build`                    — builds `csrc/*.cu` with nvcc at first use
"""

__version__ = "0.1.0"

from mpm_flip98a_tpu_torch import config as config
from mpm_flip98a_tpu_torch import state as state
