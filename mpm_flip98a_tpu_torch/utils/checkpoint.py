"""Checkpoint / resume of simulation state (counterpart of `mpm_flip98a_tpu/utils/checkpoint.py`).

`save` writes a dataclass of tensors (`Particles`, `MLS88Particles`,
`FluidBuckets`, `FluidBuckets3D`) to one compressed npz with the JAX
package's `__manifest__` (type name, `meta`, each field's dtype and
shape), and `load` restores it as that type on a device, dtypes kept.
The classes have the same names and fields in both packages, so an npz
written by either loads in the other.

Sharded checkpoints differ on purpose: the JAX package writes a per-shard
Orbax directory for a path without `.npz` (checkpoint.py:85-141), and the
port imports no JAX.  `save_sharded` writes a directory of npz files in
the format above, one per shard (shard s: its contiguous block of the
shard-major state and its `overflow[s]`), beside the JAX package's
`<path>.meta.json` sidecar; `load_sharded` restores one onto a template
state's layout and device.  A directory without shard files (an Orbax
checkpoint) raises ValueError: the port reads npz checkpoints only.
On a rank mesh (one shard per process) `save_rank_shard` has each rank
write its own shard file of the same directory format, and
`load_rank_shard` has each rank read its own: a directory written by n
shards on one device resumes on n ranks, and the reverse.

bfloat16 fields are stored as the JAX package stores them: numpy has no
bfloat16, so the npz holds 2-byte records (`|V2`) with the bits, and the
manifest names the dtype "bfloat16".  The port writes and reads that
layout through 16-bit views, so either package's file loads bit for bit
(the JAX package's own `load` cannot turn the records back into an array).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Type

import numpy as np
import torch

from mpm_flip98a_tpu_torch.state import BF16_RECORD, from_host_bits, host_bits

SHARD_FILE = "shard-{:05d}.npz"


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing: normalise so save('ck') and
    load('ck') refer to the same file."""
    return path if path.endswith(".npz") else path + ".npz"


def _host_fields(state: Any) -> dict:
    return {f.name: host_bits(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == BF16_RECORD else str(a.dtype)


def _write(path: str, type_name: str, fields: dict, meta: dict) -> None:
    manifest = {
        "type": type_name,
        "meta": meta or {},
        "fields": {k: [_dtype_name(v), list(v.shape)] for k, v in fields.items()},
    }
    np.savez_compressed(path, __manifest__=json.dumps(manifest), **fields)


def _read(path: str, state_type: Type) -> dict:
    """The fields of one npz as numpy arrays; ValueError on another type."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        if manifest["type"] != state_type.__name__:
            raise ValueError(
                f"checkpoint holds {manifest['type']}, requested {state_type.__name__}")
        fields = {name: z[name] for name in manifest["fields"]}
    for name, (dtype, _) in manifest["fields"].items():
        if dtype == "bfloat16" and fields[name].dtype != BF16_RECORD:
            raise ValueError(f"checkpoint field {name}: bfloat16 stored as "
                             f"{fields[name].dtype}, expected 2-byte records")
    return fields


def _build(state_type: Type, fields: dict, device) -> Any:
    """`state_type` of the numpy `fields` on `device`; a checkpoint written
    before `Jp` existed loads with Jp = 1 (checkpoint.py:60-67)."""
    kwargs = {name: from_host_bits(a, device) for name, a in fields.items()}
    missing = {f.name for f in dataclasses.fields(state_type)} - set(kwargs)
    if missing == {"Jp"}:
        kwargs["Jp"] = torch.ones_like(kwargs["J"])
    return state_type(**kwargs)


def save(path: str, state: Any, meta: dict | None = None) -> None:
    """Write a dataclass of tensors to `<path>` (npz)."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write(path, type(state).__name__, _host_fields(state), meta)


def load(path: str, state_type: Type, device="cpu") -> Any:
    """Restore a checkpoint written by `save` (by either package) into
    `state_type` on `device`, each field in its stored dtype."""
    return _build(state_type, _read(_npz_path(path), state_type), device)


def load_meta(path: str) -> dict:
    with np.load(_npz_path(path), allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))["meta"]


def _n_shards(state: Any) -> int:
    """Shards of a state: the length of its per-shard `overflow`; 1 for a
    single-device state (a scalar overflow, or none)."""
    ovf = getattr(state, "overflow", None)
    return 1 if ovf is None or ovf.dim() == 0 else int(ovf.shape[0])


def save_sharded(path: str, state: Any, meta: dict | None = None) -> None:
    """One npz per shard in the DIRECTORY `path` (`SHARD_FILE`): shard s
    holds rows [s P / n, (s + 1) P / n) of every field and its overflow
    entry; `meta` rides a JSON sidecar `<path>.meta.json` next to it."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for old in glob.glob(os.path.join(path, "shard-*.npz")):
        os.remove(old)
    fields = _host_fields(state)
    n = _n_shards(state)
    for s in range(n):
        part = {name: np.array_split(a, n)[s] if a.ndim else a for name, a in fields.items()}
        _write(os.path.join(path, SHARD_FILE.format(s)), type(state).__name__, part,
               {**(meta or {}), "shard": s, "shards": n})
    with open(path + ".meta.json", "w") as f:
        json.dump({"type": type(state).__name__, "meta": meta or {}}, f)


def load_sharded(path: str, template: Any) -> Any:
    """Restore a `save_sharded` directory onto `template`, the running
    state: its type, shard count, per-shard layout and device.  Raises
    ValueError on another shard count or layout, and on a directory
    without shard files (a JAX Orbax checkpoint)."""
    path = os.path.abspath(path)
    files = sorted(glob.glob(os.path.join(path, "shard-*.npz")))
    if not files:
        raise ValueError(
            f"{path} holds no {SHARD_FILE.format(0)}-style shard files: the port reads npz "
            "checkpoints only (a JAX Orbax directory cannot be restored here)")
    n = _n_shards(template)
    if len(files) != n:
        raise ValueError(f"checkpoint has {len(files)} shards, the running state {n}")
    state_type = type(template)
    parts = [_read(f, state_type) for f in files]
    fields = {}
    for name in parts[0]:
        want = getattr(template, name)
        blocks = [p[name] for p in parts]
        got = np.concatenate(blocks) if want.dim() else blocks[0]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint field {name} has shape {tuple(got.shape)} in all, "
                             f"the running state {tuple(want.shape)}: another layout")
        fields[name] = got
    device = getattr(template, dataclasses.fields(template)[0].name).device
    return _build(state_type, fields, device)


def save_rank_shard(path: str, state: Any, mesh, meta: dict | None = None) -> None:
    """`save_sharded`'s directory written by the ranks of `mesh` (a
    RankMesh; collective): rank 0 clears the old shard files, then every
    rank writes its own block as shard `mesh.rank`, then rank 0 writes the
    sidecar once all have written."""
    path = os.path.abspath(path)
    if mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        for old in glob.glob(os.path.join(path, "shard-*.npz")):
            os.remove(old)
    mesh.barrier()
    _write(os.path.join(path, SHARD_FILE.format(mesh.rank)), type(state).__name__,
           _host_fields(state), {**(meta or {}), "shard": mesh.rank, "shards": mesh.n})
    mesh.barrier()
    if mesh.rank == 0:
        with open(path + ".meta.json", "w") as f:
            json.dump({"type": type(state).__name__, "meta": meta or {}}, f)
    mesh.barrier()


def load_rank_shard(path: str, template: Any, mesh) -> Any:
    """This rank's shard of a `save_sharded` / `save_rank_shard` directory
    onto `template`, the rank's running state.  Raises ValueError on
    another shard count or layout, as `load_sharded` does."""
    path = os.path.abspath(path)
    files = sorted(glob.glob(os.path.join(path, "shard-*.npz")))
    if not files:
        raise ValueError(f"{path} holds no {SHARD_FILE.format(0)}-style shard files")
    if len(files) != mesh.n:
        raise ValueError(f"checkpoint has {len(files)} shards, the rank mesh {mesh.n}")
    fields = _read(os.path.join(path, SHARD_FILE.format(mesh.rank)), type(template))
    for name, got in fields.items():
        want = getattr(template, name)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint field {name} has shape {tuple(got.shape)} on rank "
                             f"{mesh.rank}, the running state {tuple(want.shape)}: another "
                             "layout")
    device = getattr(template, dataclasses.fields(template)[0].name).device
    return _build(type(template), fields, device)


def load_sharded_meta(path: str) -> dict:
    with open(os.path.abspath(path) + ".meta.json") as f:
        return json.load(f)["meta"]
