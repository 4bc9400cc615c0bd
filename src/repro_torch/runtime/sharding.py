"""Logical-axis sharding rules (t5x-style) with divisibility fallbacks, the
port of ``repro.runtime.sharding``.

Rules map logical dim names to mesh axes. ``resolve_dim`` checks
divisibility against the actual array shape and mesh, dropping the
annotation when it does not divide (e.g. kv_heads=8 on a model axis of 16
falls back to replicated, while the decode cache shards its seq dim instead
-- rule order encodes the preference).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``,
or, where no process group exists (the rules' tests, the dry-run's
planning), a mapping from axis name to size in mesh order. ``spec_for``
returns the reference's per-dim tuple (an axis name, a tuple of names, or
``None``): what ``tuple(PartitionSpec)`` gives there. ``placements`` turns
a spec into DTensor placements: ``Shard(d)`` on each mesh dim named by
tensor dim d, ``Replicate()`` on the rest. Where a tuple such as
``("pod", "data")`` shards one dim, DTensor splits it over the mesh dims
from left to right, so the first named axis is the major one, as in JAX;
the rules name axes in mesh order, and another order raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

DimSpec = Union[str, Tuple[str, ...], None]
Spec = Tuple[DimSpec, ...]

# each logical name maps to an ordered list of candidate mesh-axis tuples;
# the first whose product divides the dim size wins
DEFAULT_RULES: Dict[str, Sequence[Union[Tuple[str, ...], None]]] = {
    "batch": [("pod", "data"), ("data",), None],
    "vocab": [("model",), None],
    "heads_x_hd": [("model",), None],
    "kv_x_hd": [("model",), None],
    "d_ff": [("model",), None],
    "expert_ff": [None],
    "experts": [("model",), None],
    # FSDP/ZeRO: weight matrices shard their d_model dim over the data axis
    # (the step gathers weights per use, reduce-scatters grads); without it
    # a 480B MoE needs 555 GiB/chip. Activations are unaffected.
    "d_model": [("pod", "data"), ("data",), None],
    "d_inner": [("model",), None],
    "bc_dim": [("model",), None],
    "conv_dim": [("model",), None],
    "ssm_heads": [("model",), None],
    "kv_heads": [("model",), None],
    "kv_seq": [("model",), None],
    "long_seq": [("pod", "data", "model"), ("data", "model"), ("model",),
                 None],
    "layers": [None],
    "seq": [None],
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or a
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def axis_size(mesh, axes: Optional[Tuple[str, ...]]) -> int:
    if not axes:
        return 1
    sizes = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)
    return size


def resolve_dim(mesh, logical: Optional[str], size: int,
                rules: Optional[Dict] = None,
                used: Optional[set] = None) -> DimSpec:
    rules = rules or DEFAULT_RULES
    if logical is None:
        return None
    sizes = mesh_axes(mesh)
    for cand in rules.get(logical, [None]):
        if cand is None:
            return None
        axes = tuple(a for a in cand if a in sizes)
        if not axes:
            continue
        if used and any(a in used for a in axes):
            continue
        if size % axis_size(sizes, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def spec_for(mesh, logical_dims: Sequence[Optional[str]],
             shape: Sequence[int], rules: Optional[Dict] = None) -> Spec:
    used: set = set()
    parts = []
    for name, size in zip(logical_dims, shape):
        r = resolve_dim(mesh, name, size, rules, used)
        if r is not None:
            for a in (r if isinstance(r, tuple) else (r,)):
                used.add(a)
        parts.append(r)
    return tuple(parts)


def tree_specs(mesh, dims_tree: Mapping, shapes_tree: Mapping,
               rules=None) -> Dict:
    """Map a dict of logical-dims tuples and a dict of the same keys
    holding tensors or ``(shape, dtype)`` stand-ins to specs."""
    return {k: spec_for(mesh, dims, shape_of(shapes_tree[k]), rules)
            for k, dims in dims_tree.items()}


def shape_of(leaf) -> Tuple[int, ...]:
    """The shape of a tensor or of a ``(shape, dtype)`` stand-in."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def placements(mesh, spec: Spec):
    """DTensor placements of ``spec`` on ``mesh`` (module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shardings(mesh, specs_tree: Mapping) -> Dict:
    """``(mesh, placements)`` for every spec of a dict: the counterpart of
    ``NamedSharding``."""
    return {k: (mesh, placements(mesh, s)) for k, s in specs_tree.items()}


@contextlib.contextmanager
def implicit_replication(x):
    """Where ``x`` is a DTensor, DTensor's implicit replication: a plain
    tensor made inside a step (positions, masks, constants) is taken as
    replicated over the mesh. Unlike ``torch``'s context of that name, this
    one nests: it restores the setting it found. Where ``x`` is a plain
    tensor it does nothing."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        yield
        return
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def constrain(x, logical_dims: Sequence[Optional[str]]):
    """The counterpart of ``with_sharding_constraint`` on a mesh: ``x``
    redistributed to the placements that the rules give ``logical_dims``
    (unnamed dims whole), and its gradient redistributed to the same
    placements on the way back. Without the second half DTensor keeps
    whatever placement a gradient arrives in, and may pick a costly
    strategy for the next op of the backward (gather a weight over
    ``model`` and repeat its product on every rank when a gradient is
    partial) or reach a placement it has no strategy for (a sequence dim
    split over ``model``, flattened with the batch dim). A plain tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(mesh, spec_for(mesh, logical_dims, x.shape))
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return _GradPlaced.apply(x, want)


class _GradPlaced(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient."""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pls), None


def grad_placements(in_pls: Sequence[Sequence]) -> Tuple[list, ...]:
    """``local_map``'s ``in_grad_placements`` for inputs placed as
    ``in_pls``: an input whole over a mesh dim on which another input is
    split (a weight beside a batch-sharded activation) gets, from each
    rank, the gradient of that rank's share only: ``Partial`` there, to be
    summed. Every other placement is the input's own."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = {i for pls in in_pls for i, p in enumerate(pls)
             if isinstance(p, Shard)}
    return tuple([Partial() if isinstance(p, Replicate) and i in split
                  else p for i, p in enumerate(pls)] for pls in in_pls)


def on_shards(fn, args, in_dims, out_dims, axis: Mapping[str, DimSpec]):
    """``fn(*local shards of args)`` through ``local_map``. ``in_dims`` and
    ``out_dims`` name each dim of each argument and output (``None``:
    whole); ``axis`` maps a name to its mesh axes (``resolve_dim``'s
    answer, decided once so that every tensor splits alike). Gradients of
    inputs whole over an axis that splits another input come back
    ``Partial`` there (``grad_placements``). One output is returned as a
    tensor, several as a tuple."""
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh

    def pls(dims):
        return list(placements(mesh, tuple(axis.get(n) if n else None
                                           for n in dims)))

    ins = tuple(pls(d) for d in in_dims)
    outs = tuple(pls(d) for d in out_dims)
    return local_map(fn, out_placements=outs[0] if len(outs) == 1 else outs,
                     in_placements=ins,
                     in_grad_placements=grad_placements(ins),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
