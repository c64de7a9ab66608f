"""The mesh surface every other module of the port is written against;
port of repro.distributed.compat.

The reference bridges two spellings of JAX's sharding API.  Two of its
three functions have counterparts here:

* :func:`set_mesh` — the mesh context: a ``DeviceMesh`` is itself a
  context manager (it becomes torch's current mesh); a shape-only mesh
  (the rule tests' ``FakeMesh``) needs no context;
* :func:`axis_size` — ``mesh.size(axis)`` of the active mesh;
* ``shard_map`` has none yet: on the port's serving path every tensor is
  a plain per-rank tensor (the rank holds its own shard), so
  ``dispatch.shard.run_sharded`` calls its body on them directly; a
  ``local_map`` bridge waits for a DTensor path (ROADMAP A13c).

:func:`axes_of` reads a mesh's ``{axis: size}``, whatever its type, as
the reference reads ``mesh.shape``; :func:`placements` turns a spec into
DTensor placements (``sharding.shardings``).
"""

from __future__ import annotations

import contextlib


# id of a DeviceMesh -> (the mesh, its axes): a mesh's layout is fixed,
# and reading it builds a tensor (tens of microseconds, several times a
# linear and step)
_AXES: dict[int, tuple] = {}


def axes_of(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a shape-only mesh
    whose ``shape`` is that dict already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    hit = _AXES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = _AXES[id(mesh)] = (mesh, dict(zip(
            names, (int(s) for s in mesh.mesh.shape))))
    return dict(hit[1])


def set_mesh(mesh):
    """Context manager activating ``mesh`` as torch's current mesh."""
    if hasattr(mesh, "__enter__"):
        return mesh
    return contextlib.nullcontext(mesh)


def axis_size(axis: str) -> int:
    """Size of a named axis of the active mesh (``sharding.use``)."""
    from repro_torch.distributed.sharding import active_mesh

    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"axis_size({axis!r}) outside a mesh")
    return axes_of(mesh)[axis]


def placements(spec: tuple, mesh) -> tuple:
    """A spec (one entry a tensor dim: None, a mesh axis name or a tuple
    of them) as DTensor placements, one a mesh dim: ``Shard(dim)`` where
    the spec names the mesh dim, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axes_of(mesh):
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)
