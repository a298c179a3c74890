"""Logical-axis sharding rules on ``torch.distributed`` (port of
``repro/sharding/__init__.py``).

Every parameter, state and activation is annotated with *logical* axis
names ("embed", "heads", "ffn", ...). A :class:`Rules` table maps the
logical names to the named dimensions of a ``DeviceMesh``; ``Rules.spec``
resolves a tuple of logical names into JAX's per-dimension form (one
entry per tensor dim: a mesh axis, a tuple of mesh axes, or None), and
:func:`placements` turns that into DTensor placements, one per mesh dim.
The indirection lets one model definition run on a (data, model) mesh,
a (pod, data, model) mesh, a smoke mesh, or one device without touching
model code.

===============  =======================  =====================================
logical axis     physical axes            carried by
===============  =======================  =====================================
batch            ("pod", "data")          activations' batch dim (DP)
fsdp             ("pod", "data")          params' d_model dim (ZeRO-3 / FSDP)
vocab            "model"                  embedding + logits (TP)
heads            "model"                  q heads (TP) — if divisible
kv_heads         "model"                  kv heads (TP) — if divisible
head_dim         None | "model"           per-arch: "head_dim" shard mode
ffn              "model"                  MLP hidden (TP)
experts          "model"                  MoE experts (EP)
d_inner          "model"                  Mamba inner dim (TP)
seq              None                     sequence (dense compute)
seq_sp           "model"                  sequence-parallel residual stream
state_k/state_v  None                     the paper's k×k state dims (tiny)
===============  =======================  =====================================

All rules degrade gracefully: a physical axis absent from the mesh
resolves to None (replicated), and a logical dim whose size does not
divide the mesh axis falls back to replicated.

GSPMD's role, partitioning the program from the annotations, is played
by DTensor's sharding propagation; ``constrain`` is a ``redistribute``.
A tensor dim over several mesh axes, ``("pod", "data")``, gets
``Shard(d)`` on each of them in mesh order, which splits it pod-major
as JAX's ``NamedSharding`` does, so every rank's local block is the
block JAX puts on the device at the same mesh coordinates. An uneven
split (``UNEVEN_OK``) gives the first ranks ceil(n / m) rows and the
last what remains, as both libraries do.

The kernels are bound through ``ctypes`` and take plain tensors: each
kernel call site runs under :func:`local_call`, DTensor's
``local_map``, so each rank calls its kernel on its own heads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch


Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "vocab": "model",
    "heads": "model",            # flattened h*dh projection dims (params)
    "kv_heads_flat": "model",    # flattened hkv*dh projection dims
    "kv_heads": "model",         # activation Hkv dim (uneven allowed)
    "kv_heads_state": "model",   # decode-state Hkv dim (must divide; the
                                 # fallback drops to None and
                                 # head_dim_state takes the model axis)
    "group": "model",            # activation GQA group dim (uneven allowed)
    "heads_lin": "model",        # linear-backend flat head dim (uneven ok)
    "heads_state": "model",      # matrix-state head dim (must divide)
    "head_dim": None,
    "head_dim_state": "model",   # KV-cache head_dim (decode fallback TP)
    "ffn": "model",
    "experts": "model",
    "d_inner": "model",
    "conv_dim": "model",
    "seq": None,
    "seq_sp": "model",
    "state_k": None,
    "state_v": None,
    "embed": None,        # activations' d_model dim (replicated; TP is on
                          # the contracting param dims)
    "layers": None,       # stacked scan-over-layers leading dim
    "img_tokens": None,
}

# Logical axes that may shard unevenly: activation head dims where the
# head count need not divide the mesh. Parameter dims never shard
# unevenly.
UNEVEN_OK = {"kv_heads", "group", "heads_lin"}


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical→physical axis mapping, specialised to a concrete mesh.
    ``mesh`` is the ``DeviceMesh`` the rules were made for (None for
    rules built from a table alone, which resolve specs but place
    nothing)."""

    table: Dict[str, Axis]
    mesh_axes: Tuple[str, ...]
    mesh_shape: Dict[str, int]
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def for_mesh(cls, mesh, overrides: Optional[Dict[str, Axis]] = None
                 ) -> "Rules":
        table = dict(DEFAULT_RULES)
        if overrides:
            table.update(overrides)
        names = tuple(mesh.mesh_dim_names)
        return cls(table=table, mesh_axes=names,
                   mesh_shape={a: int(s) for a, s in zip(names, mesh.shape)},
                   mesh=mesh)

    @classmethod
    def null(cls) -> "Rules":
        """Rules for un-meshed (single device) execution: everything
        replicated."""
        return cls(table={}, mesh_axes=(), mesh_shape={})

    # -- resolution ----------------------------------------------------------

    def axis_size(self, name: str) -> int:
        return self.mesh_shape.get(name, 1)

    @property
    def model_size(self) -> int:
        return self.axis_size("model")

    @property
    def data_size(self) -> int:
        return self.axis_size("data") * self.axis_size("pod")

    @property
    def on_mesh(self) -> bool:
        """True when tensors are placed on a mesh (DTensors)."""
        return self.mesh is not None

    def _resolve_axis(self, logical: Optional[str], dim_size: Optional[int]
                      ) -> Axis:
        if logical is None:
            return None
        phys = self.table.get(logical, None)
        if phys is None:
            return None
        if isinstance(phys, str):
            phys = (phys,)
        phys = tuple(a for a in phys if a in self.mesh_axes)
        if not phys:
            return None
        if dim_size is not None and logical not in UNEVEN_OK:
            if dim_size % _prod(self.mesh_shape, phys) != 0:
                # divisibility fallback: drop axes from the left until the
                # remaining product divides (pod first, then data)
                while phys and dim_size % _prod(self.mesh_shape, phys) != 0:
                    phys = phys[1:]
                if not phys:
                    return None
        return phys if len(phys) > 1 else phys[0]

    def spec(self, *logical: Optional[str],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Resolve logical names (one per tensor dim) to JAX's
        per-dimension partition spec, as a tuple. ``shape``, when given,
        enables the divisibility fallback per dim. A mesh axis used by
        an earlier dim is dropped from a later one."""
        out = [self._resolve_axis(name, None if shape is None else shape[i])
               for i, name in enumerate(logical)]
        seen = set()
        cleaned = []
        for ax in out:
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            if any(a in seen for a in axes):
                cleaned.append(None)
                continue
            seen.update(axes)
            cleaned.append(ax)
        return tuple(cleaned)


def _prod(shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    total = 1
    for a in axes:
        total *= shape[a]
    return total


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh_axes: Sequence[str]) -> Tuple[Any, ...]:
    """DTensor placements (one per mesh dim) of a per-tensor-dim spec:
    mesh dim ``a`` gets ``Shard(d)`` where ``a`` names tensor dim ``d``,
    ``Replicate()`` elsewhere. A tensor dim over several mesh axes must
    list them in mesh order, which is the nesting JAX's
    ``NamedSharding`` gives (the first axis major)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_axes]
    for d, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else (ax or ())
        idx = [list(mesh_axes).index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not "
                             f"in mesh order {tuple(mesh_axes)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_logical_spec(x) -> bool:
    """A tuple of logical axis names (str | None) — not a NamedTuple
    (AttnState etc. are tuples too; they must be descended into)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def tree_specs(logical_tree, rules: Rules, shape_tree=None):
    """Map a tree of logical-name tuples to a tree of specs; with
    ``shape_tree`` (same structure, shapes as leaves) the divisibility
    fallback applies per dim."""
    if isinstance(logical_tree, dict):
        return {k: tree_specs(v, rules, None if shape_tree is None
                              else shape_tree[k])
                for k, v in logical_tree.items()}
    if logical_tree is None:
        return None
    if is_logical_spec(logical_tree):
        return rules.spec(*logical_tree, shape=shape_tree)
    items = [tree_specs(v, rules, None if shape_tree is None
                        else shape_tree[i])
             for i, v in enumerate(logical_tree)]
    return (type(logical_tree)(*items) if hasattr(logical_tree, "_fields")
            else type(logical_tree)(items))


def distribute(x: torch.Tensor, rules: Rules, *logical: Optional[str]
               ) -> torch.Tensor:
    """Place a whole tensor, the same on every rank, on the rules' mesh
    by its logical names (each rank keeps its own block; no
    communication). Identity under null rules."""
    if not rules.on_mesh:
        return x
    from torch.distributed.tensor import distribute_tensor
    pl = placements(rules.spec(*logical, shape=x.shape), rules.mesh_axes)
    return distribute_tensor(x, rules.mesh, pl, src_data_rank=None)


def distribute_tree(tree, logical_tree, rules: Rules):
    """:func:`distribute` leaf by leaf (``logical_tree`` of the same
    structure; a None spec leaf goes with a None tensor leaf)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], logical_tree[k], rules)
                for k in tree}
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        items = [distribute_tree(t, s, rules)
                 for t, s in zip(tree, logical_tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return distribute(tree, rules, *logical_tree)


def full(x):
    """The whole tensor of a DTensor (a collective); a plain tensor as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x, rules: Rules, *logical: Optional[str]):
    """JAX's ``with_sharding_constraint`` in logical names: a DTensor is
    redistributed to the placements the names resolve to; a plain
    tensor, or any tensor under null rules, comes back as it is."""
    if not rules.mesh_axes or not is_dtensor(x):
        return x
    pl = placements(rules.spec(*logical, shape=x.shape), rules.mesh_axes)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor
    runs the backward of a reshape as a ``view`` of each rank's block,
    which a permuted gradient cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


class _GradAsForward(torch.autograd.Function):
    """Identity whose backward gives the gradient the placements of the
    forward value: DTensor runs the backward of a reshape on the
    gradient's placements, which may split a dim the reshape cannot."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is the same on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def grad_as_forward(x):
    """Put after a reshape whose gradient may come back split unevenly,
    on a DTensor."""
    return _GradAsForward.apply(x) if is_dtensor(x) else x


def dense_grad(x):
    """Put after a reshape that a permute follows, on a DTensor."""
    return _DenseGrad.apply(x) if is_dtensor(x) else x


def split_last(x, *sizes: int):
    """``x.reshape(*x.shape[:-1], *sizes)``; a DTensor whose last dim is
    split over a mesh dim that does not divide ``sizes[0]`` (the new
    outer dim, e.g. 6 heads on 4 ranks) is gathered on that mesh dim
    first, since DTensor cannot split an uneven shard."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        mesh = x.device_mesh
        pl = [Replicate() if p.is_shard(last)
              and sizes[0] % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


def whole_dims(x, *dims: int):
    """``x`` with ``dims`` not split over any mesh dim (a DTensor is
    gathered on the mesh dims that split them; a plain tensor comes back
    as it is): a reshape that merges a split dim into the one before it
    needs the redistribution some torch versions' DTensor refuses to
    make for it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def whole_if_uneven(x, dim: int):
    """``x`` with ``dim`` gathered where the mesh dims that split it do
    not divide its size (56 heads over 16 ranks): DTensor cannot reshape
    an uneven split, nor the gradient that flows back through it."""
    if not is_dtensor(x):
        return x
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim % x.ndim):
            n *= x.device_mesh.size(i)
    return x if x.shape[dim] % n == 0 else whole_dims(x, dim % x.ndim)


def map_local(fn: Callable, x, shape: Sequence[int]):
    """``fn`` on each rank's block of ``x`` where it acts on a dim that is
    not split (a KV cache grown along its rows), the result placed as
    ``x`` with the whole ``shape``; ``fn(x)`` for a plain tensor."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def replicated_like(t: torch.Tensor, ref):
    """``t``, the same on every rank, as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor (no communication), so that the
    backward of an op mixing the two meets no plain tensor."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mixed_for(tree):
    """``replicate_mixed()`` when ``tree`` holds a DTensor, else a
    context that does nothing."""
    import contextlib
    from repro_torch.tree import leaves
    if any(is_dtensor(x) for x in leaves(tree)):
        return replicate_mixed()
    return contextlib.nullcontext()


def replicate_mixed():
    """A context in which plain tensors (positions, masks, RoPE tables)
    that meet DTensors count as replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


# ---------------------------------------------------------------------------
# kernel call sites
# ---------------------------------------------------------------------------

Names = Optional[Tuple[Optional[str], ...]]


def local_call(fn: Callable, rules: Rules, args: Sequence[Any],
               names: Sequence[Names], out_names: Sequence[Names], *,
               out_shapes: Optional[Sequence[Any]] = None,
               grad_partial: Sequence[int] = (),
               inplace: Sequence[int] = ()):
    """Run ``fn`` on each rank's own blocks (DTensor's ``local_map``).

    ``args`` are tensors (DTensors, or plain tensors that are the same
    on every rank) or None; ``names[i]`` gives the logical names of
    ``args[i]``'s dims, resolved with its shape, and its inputs are
    redistributed to those placements first (a state updated in place
    must already have them). ``out_names`` name the outputs' dims
    (None for an output that is None), resolved with ``out_shapes``
    (the global shapes; default: the shape of the argument with the
    same names). ``grad_partial``: indices of inputs that every rank
    reads whole although the outputs are split (k and v read by every
    rank's q heads): their gradients are partial sums over the mesh.
    ``inplace``: indices of inputs that ``fn`` updates in place (decode
    states): they must already have their placements, since a
    redistributed copy would take the update instead.

    ``out_names`` of one entry: ``fn`` returns one tensor."""
    from torch.distributed.tensor import Partial, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = rules.mesh
    in_pl, grad_pl, wrapped = [], [], []
    for i, (a, nm) in enumerate(zip(args, names)):
        if a is None:
            in_pl.append(None)
            grad_pl.append(None)
            wrapped.append(None)
            continue
        pl = placements(rules.spec(*nm, shape=a.shape), rules.mesh_axes)
        if i in inplace and (not is_dtensor(a)
                             or tuple(a.placements) != pl):
            raise ValueError(
                f"a state updated in place must be a DTensor placed as "
                f"{pl} on {mesh}, not "
                f"{getattr(a, 'placements', 'a plain tensor')} on "
                f"{getattr(a, 'device_mesh', None)}")
        if not is_dtensor(a):
            a = distribute_tensor(a, mesh, pl, src_data_rank=None)
        in_pl.append(pl)
        grad_pl.append(tuple(Partial() if i in grad_partial
                             and not p.is_shard() else p for p in pl))
        wrapped.append(a)
    if out_shapes is None:
        out_shapes = []
        for nm in out_names:
            src = next((a for a, n in zip(args, names)
                        if a is not None and n == nm), None)
            out_shapes.append(None if src is None else src.shape)
    out_pl = tuple(None if nm is None else placements(
        rules.spec(*nm, shape=shp), rules.mesh_axes)
        for nm, shp in zip(out_names, out_shapes))
    if len(out_pl) == 1:       # one output: its placements as a list
        out_pl = list(out_pl[0])
    mapped = local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                       in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(*wrapped)


def kernel_site(fn: Callable, rules: Rules, args: Sequence[Any],
                names: Sequence[Names], out_names: Sequence[Names], **kw):
    """``fn(*args)``; on a mesh, :func:`local_call` on each rank's own
    blocks."""
    if not rules.on_mesh:
        return fn(*args)
    return local_call(fn, rules, args, names, out_names, **kw)
