"""The port's counterparts of ``jax.sharding.PartitionSpec`` and
``jax.sharding.NamedSharding``, which the JAX package takes from JAX
itself: a spec of mesh axes per tensor dimension, and a mesh with a spec
(core/mesh.py builds the meshes). A spec may name any axis of its mesh:
``build_mesh``'s (dp, pp, tp, sp, ep) or a plan's (dp, fsdp, tp[, ep])."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple, Union

from .enforce import enforce

AXIS_NAMES = ("dp", "pp", "tp", "sp", "ep")


def _axes(axis: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class PartitionSpec(tuple):
    """How a tensor's dimensions map onto mesh axes (``jax.sharding.
    PartitionSpec``): one entry per leading dimension, each None
    (replicated), an axis name or a tuple of names (split over their
    product, the first name outermost); dimensions past the entries are
    replicated. A tuple of one name is that name, as JAX stores it."""

    def __new__(cls, *parts):
        parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                      for p in parts)
        return super().__new__(cls, parts)

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class NamedSharding:
    """A mesh and a :class:`PartitionSpec` (``jax.sharding.
    NamedSharding``): ``placements`` are its DTensor placements, one per
    mesh axis; ``index(shape)`` is this rank's slice of a global tensor
    of ``shape`` and ``local(x)`` that slice of ``x``."""

    def __init__(self, mesh, spec: PartitionSpec):
        spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)
        for part in spec:
            if part is not None:
                mesh.axis_size(part)
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.axis_names)
        out = [Replicate()] * len(names)
        for dim, part in enumerate(self.spec):
            if part is not None:
                for a in _axes(part):
                    out[names.index(a)] = Shard(dim)
        return tuple(out)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec splits over, in spec order."""
        return tuple(a for part in self.spec if part is not None
                     for a in _axes(part))

    def local_shape(self, shape: Iterable[int]) -> Tuple[int, ...]:
        """The shape of this rank's shard of a global ``shape``."""
        return tuple(s.stop - s.start if s.stop is not None else n
                     for s, n in zip(self.index(shape), tuple(shape)))

    def index(self, shape: Iterable[int]):
        shape = tuple(shape)
        enforce(len(self.spec) <= len(shape), "spec %s has more entries "
                "than the %s dims of %s", self.spec, len(shape), shape)
        out = []
        for dim, n in enumerate(shape):
            part = self.spec[dim] if dim < len(self.spec) else None
            if part is None:
                out.append(slice(None))
                continue
            k = self.mesh.axis_size(part)
            enforce(n % k == 0, "dim %s of size %s does not split over %s "
                    "(%s ranks)", dim, n, part, k)
            i = self.mesh.axis_index(part)
            out.append(slice(i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    def local(self, x):
        """This rank's shard of the global tensor (or array) ``x``."""
        return x[self.index(x.shape)]
