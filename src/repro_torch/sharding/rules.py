"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks.

Every parameter and activation of the model carries *logical* axis names
("batch", "seq", "embed", "heads", "mlp", "vocab", "expert", ...).  A
:class:`ShardingRules` maps logical names to mesh axes; when a tensor
dimension is not divisible by the product of its mesh axes the rule falls
back to replication for that dimension (e.g. kv_heads=4 on a model axis of
16).

A mesh is anything that gives axis sizes by name: a live
:class:`torch.distributed.device_mesh.DeviceMesh` (``mesh_dim_names`` and
``shape``), a plain mapping such as ``{"data": 16, "model": 16}``, or an
object with a ``shape`` mapping.  :func:`logical_spec` and
:func:`placements` read sizes only, so a 256- or 512-device production mesh
can be asked about without 256 processes.  A spec is a tuple with one entry
per tensor dim: ``None``, a mesh axis name, or a tuple of them.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class Shard:
    """DTensor's ``Shard(dim)`` placement: tensor dim ``dim`` is split over
    the mesh dim (a copy of the name, without importing DTensor, whose
    import costs a second)."""
    dim: int


@dataclass(frozen=True)
class Replicate:
    """DTensor's ``Replicate()`` placement."""


MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclass
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        axes = self.rules.get(name, None)
        if isinstance(axes, list):  # JSON overrides arrive as lists
            axes = tuple(axes)
        return axes

    def with_overrides(self, **kw: MeshAxes) -> "ShardingRules":
        r = dict(self.rules)
        r.update(kw)
        return ShardingRules(r)


def default_rules(multi_pod: bool = False, pod_role: str = "dp"
                  ) -> ShardingRules:
    """The baseline rule set.

    - batch          -> DP over (pod, data)
    - fsdp           -> parameter reduction dims sharded over "data" (ZeRO-3)
    - heads/mlp/vocab/expert -> TP/EP over "model"
    - seq            -> unsharded by default (SP enabled per shape by
      overrides)
    """
    batch: MeshAxes = ("pod", "data") if (multi_pod and pod_role == "dp") \
        else "data"
    return ShardingRules({
        "batch": batch,
        "seq": None,
        "seq_sp": None,         # residual-stream seq dim (SP override)
        "embed": None,          # activation d_model dim
        "heads": "model",
        "kv_heads": "model",    # falls back to None when not divisible
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",      # EP
        "capacity": None,
        "fsdp": "data",         # weight reduction dim (ZeRO-3 style)
        "layers": None,         # stacked layer axis
        "rank": None,           # PEFT subspace dims are tiny -> replicate
        "oft_blocks": None,     # OFT/BOFT rotation-block axis -> replicate
        "state": None,          # SSM state dim
        "conv_ch": "model",     # SSM conv channels (d_inner + 2GN)
        "cache_seq": None,      # KV-cache sequence dim (decode override)
        "stage": "pod" if (multi_pod and pod_role == "pp") else None,
    })


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes by name, in mesh order, of a ``DeviceMesh``, a mapping or
    an object with a ``shape`` mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def batch_axes(mesh, rules: ShardingRules) -> Tuple[str, ...]:
    """The axes of ``mesh`` that ``rules`` split the batch over."""
    axes = rules.get("batch")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if a in shape)


def _axis_size(shape: Mapping[str, int], axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= shape.get(a, 1)
    return size


def logical_spec(mesh, rules: ShardingRules,
                 logical_axes: Sequence[Optional[str]],
                 dims: Optional[Sequence[int]] = None) -> Spec:
    """The spec of ``logical_axes``; an assignment is dropped where its mesh
    axes do not exist, are already used by an earlier dim, or (when
    ``dims`` is given) do not divide the dimension (a prefix of an axes
    tuple that divides is kept)."""
    shape = mesh_shape(mesh)
    out = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        axes = rules.get(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in shape and a not in used)
        if not axes:
            out.append(None)
            continue
        if dims is not None and dims[i] % _axis_size(shape, axes) != 0:
            while axes and dims[i] % _axis_size(shape, axes) != 0:
                axes = axes[:-1]
            if not axes:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


@dataclass(frozen=True)
class Placements:
    """A tensor's layout on a mesh: one DTensor placement per mesh dim
    (``Shard(d)`` where tensor dim ``d`` is split over that mesh dim,
    ``Replicate()`` elsewhere), with the mesh's axis names and sizes and
    the tensor's rank.  A tensor dim split over several mesh dims is split
    row-major over them in mesh order.  A leaf of the port's trees (a tuple
    would be walked)."""
    placements: Tuple[Union[Shard, Replicate], ...]
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ndim: int

    @property
    def is_replicated(self) -> bool:
        return not any(isinstance(p, Shard) for p in self.placements)

    def dim_axes(self, ndim: Optional[int] = None
                 ) -> Dict[int, Tuple[Tuple[str, int], ...]]:
        """Tensor dim -> the (mesh axis, size) pairs that split it, in mesh
        order.  With ``ndim`` the dims count from the tensor's last
        ``ndim`` (a layer's slice of a stack drops the leading stack dims,
        which no rule splits)."""
        lead = self.ndim - (self.ndim if ndim is None else ndim)
        out: Dict[int, Tuple[Tuple[str, int], ...]] = {}
        for p, name, size in zip(self.placements, self.names, self.sizes):
            if isinstance(p, Shard):
                d = p.dim - lead
                out[d] = out.get(d, ()) + ((name, size),)
        return out

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape``."""
        out = list(shape)
        for d, axes in self.dim_axes(len(shape)).items():
            for _, size in axes:
                out[d] //= size
        return tuple(out)


def placements(mesh, rules: ShardingRules,
               logical_axes: Sequence[Optional[str]],
               dims: Optional[Sequence[int]] = None) -> Placements:
    """The port's counterpart of the reference's ``named_sharding``:
    :func:`logical_spec` (divisibility fallback included) as one placement
    per mesh dim."""
    shape = mesh_shape(mesh)
    spec = logical_spec(mesh, rules, logical_axes, dims)
    by_axis: Dict[str, int] = {}
    for d, axes in enumerate(spec):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            by_axis[a] = d
    return Placements(tuple(Shard(by_axis[a]) if a in by_axis
                            else Replicate() for a in shape),
                      tuple(shape), tuple(shape.values()), len(logical_axes))


# ---------------------------------------------------------------------------
# the mesh context model code reads (shard_act, MoE dispatch groups)
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[ShardingRules]):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _tls.ctx = prev


def current_rules():
    """``(mesh, rules)`` of the innermost :func:`mesh_context`, or None."""
    return getattr(_tls, "ctx", None)


def shard_act(x, logical_axes: Sequence[Optional[str]]):
    """The reference's activation constraint, at its call sites, where it
    asks XLA for the compute split over the ``model`` axis.  The port
    makes that split by hand in the sharded train step
    (:mod:`repro_torch.distributed.tensor_parallel`: the model code runs
    each rank's heads, MLP columns and vocabulary slice and sums the
    partial row products), so ``x`` comes back unchanged."""
    return x
