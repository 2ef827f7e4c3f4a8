"""The port's partition model (port-only): per-device FLOPs, bytes and
collectives of a step on a device mesh, from the step itself run on meta
tensors. It takes the role of `repro.launch.hlo_analysis`, which reads
them from XLA's partitioned HLO; the port has no compiled program.

`trace(mesh)` runs a step under a `TorchDispatchMode`. Arguments enter with
their partition specs (`Trace.place`); `transformer._constrain` sets a
tensor's spec inside the trace (`Trace.constrain`). Every aten op then
carries a layout from its inputs to its outputs, as GSPMD's propagation
does, and is counted on its local (per-device) shapes:

  * A layout gives each dimension a tuple of atoms, (size, pieces): a
    dimension split by a reshape keeps one atom a factor, and a piece
    (axis, size, stride) is a digit of a mesh axis, so a 16-way axis can
    shard 4 heads 4 ways and each head's width 4 ways (GQA's KV heads).
    A dimension's local size is the product of its atoms' ceil(size /
    shards): XLA pads an uneven dimension.
  * Elementwise ops (with broadcast) take the most sharded layout of each
    dimension among their operands; a replicated operand is sliced
    locally for free. Views, reshapes, transposes, slices and indexing
    move the atoms. Matmuls (`mm`, `bmm`, `addmm`, `baddbmm`, the ops
    `einsum` becomes) keep the larger operand's layout and reshard the
    other; a contraction sharded on both sides is a partial sum, counted
    as an all-reduce of the output. Their FLOPs are
    `torch.utils.flop_counter`'s on the local shapes; their bytes are
    lhs + rhs + out, local.
  * A reduction over a sharded dimension is an all-reduce of its output
    (logsumexp two: a max and a sum). Resharding a tensor counts an
    all-gather (a sharding dropped), an all-to-all (a sharding moved) or
    nothing (a sharding added: a local slice); a slice of a sharded
    dimension that stays sharded, and a flip of one, a
    collective-permute.
  * A tensor made by a creation op (`zeros`, `full`, `arange`, ...) or
    scattered into one has no layout until it is used: its first consumer
    decides it, as GSPMD's propagation reaches it from there, and a
    pending partial sum (a scatter from batch-sharded rows) becomes a
    reduce-scatter or an all-reduce then.
  * An op without a rule gathers its sharded inputs (all-gathers) and runs
    replicated, GSPMD's own fallback; `fallback_ops` lists them by name.

Collective bytes are the local bytes of each collective's result, as
`hlo_analysis` counts them. Each collective also notes whether its group
of positions lies within one host of `HOST_CARDS` cards (positions
numbered row-major over the mesh axes), for the roofline's link term.
Memory: the live local bytes of every tensor the step makes (its
arguments apart), through the storages' lifetimes; `summary` gives their
peak without the step's outputs.
"""
from __future__ import annotations

import contextlib
import gc
import math
import weakref
from collections import Counter

import torch
from torch.utils import flop_counter as FC
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
HOST_CARDS = 8  # cards a host (a DGX H100): a group within them talks over NVLink

_STACK: list["Trace"] = []


def current() -> "Trace | None":
    """The innermost active trace, or None outside every trace."""
    return _STACK[-1] if _STACK else None


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------
# piece  = (axis, size, stride): the digit (coord // stride) % size of a mesh axis
# atom   = (size, pieces): a factor of a dimension, sharded over its pieces
# dim    = tuple of atoms (size-1 atoms dropped; a size-1 dimension is ())
# layout = tuple of dims


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size} of a `dist.mesh.Mesh` (or of such a dict)."""
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def _n(pieces) -> int:
    n = 1
    for p in pieces:
        n *= p[1]
    return n


def _dim_local(dim) -> int:
    n = 1
    for size, pieces in dim:
        n *= -(-size // _n(pieces))
    return n


def local_shape(layout) -> tuple[int, ...]:
    return tuple(_dim_local(d) for d in layout)


def _numel(shape) -> int:
    return math.prod(shape)


def _canon_pieces(pieces) -> tuple:
    out = []
    for p in pieces:
        if out and out[-1][0] == p[0] and out[-1][2] == p[1] * p[2]:
            q = out.pop()
            p = (p[0], q[1] * p[1], p[2])
        out.append(p)
    return tuple(out)


def _canon_dim(atoms) -> tuple:
    """Size-1 atoms dropped; an unsharded atom folded into the atom before
    it (a sharded major factor followed by replicated minor ones is one
    contiguous block a device)."""
    out = []
    for size, pieces in atoms:
        if size == 1:
            continue
        if out and not pieces and (not out[-1][1] or out[-1][0] % _n(out[-1][1]) == 0):
            s0, p0 = out.pop()
            out.append((s0 * size, p0))
            continue
        out.append((size, _canon_pieces(pieces)))
    return tuple(out)


def _rep_dim(size: int) -> tuple:
    return () if size == 1 else ((size, ()),)


def replicated(shape) -> tuple:
    return tuple(_rep_dim(s) for s in shape)


def layout_of_spec(shape, spec, mesh: dict[str, int]) -> tuple:
    """The layout of a tensor of `shape` under a partition spec (a tuple
    like `transformer.P`, shorter than the rank means None after)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for size, entry in zip(shape, spec):
        names = _axes(entry)
        for a in names:
            if a not in mesh:
                raise ValueError(f"axis {a!r} of spec {spec} is not a mesh axis of {mesh}")
        if size == 1 and not names:
            out.append(())
        else:
            out.append(((size, tuple((a, mesh[a], 1) for a in names if mesh[a] > 1)),))
    return tuple(out)


def spec_of_layout(layout, mesh: dict[str, int]) -> tuple:
    """The partition spec a layout reads as: each dimension's axis names
    (None when it is replicated); a dimension sharded on part of an axis
    names the part, "axis/size"."""
    out = []
    for dim in layout:
        names = [a if (size, stride) == (mesh[a], 1) else f"{a}/{size}"
                 for _, pieces in dim for a, size, stride in pieces]
        out.append(None if not names else names[0] if len(names) == 1 else tuple(names))
    return tuple(out)


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A position's shape of a tensor of global `shape` under `spec`: each
    dimension divided by the product of its axes' sizes, the ceiling where
    they do not divide it (XLA pads)."""
    ms = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(-(-s // math.prod(ms[a] for a in _axes(e))) for s, e in zip(shape, spec))


def paired(tree, specs):
    """(tensor, spec) for every tensor of a tree (nested dicts, lists and
    tuples) and the matching leaf of its spec tree."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from paired(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"a node of {len(tree)} leaves has {len(specs)} specs")
        for t, s in zip(tree, specs):
            yield from paired(t, s)


def _nones(tree):
    """A spec tree of `tree`'s structure, every leaf None."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {k: _nones(v) for k, v in tree.items()}
    return [_nones(v) for v in tree]


def _pieces(layout) -> list:
    return [p for dim in layout for _, ps in dim for p in ps]


def _overlap(p, q) -> bool:
    return p[0] == q[0] and p[2] < q[2] * q[1] and q[2] < p[2] * p[1]


def _conflicts(pieces, used) -> bool:
    return any(_overlap(p, q) for p in pieces for q in used)


def _dim_pieces(dim) -> tuple:
    return tuple(p for _, ps in dim for p in ps)


def _split_pieces(pieces, major: int):
    """Pieces of `major` shards (the most major digits first) and the rest,
    or None when `major` does not divide them so."""
    take, rest, got = [], list(pieces), 1
    while got < major and rest:
        a, size, stride = rest.pop(0)
        need = major // got
        if size <= need:
            if need % size:
                return None
            take.append((a, size, stride))
            got *= size
        else:
            if size % need:
                return None
            take.append((a, need, stride * (size // need)))
            rest.insert(0, (a, size // need, stride))
            got *= need
    if got != major:
        return None
    return tuple(take), tuple(rest)


def _split_atom(size: int, pieces, major: int):
    """Atom (size, pieces) as a (major, size // major) pair of atoms and
    whether the split moves data, or None when its sharding cannot follow.
    A sharding the major factor divides, or that divides it, splits in
    place (each position's block stays inside one major index); otherwise
    the major factor takes gcd(major, shards) of the pieces and the minor
    the rest (40 heads over 16 positions: 8 ways, each head's width 2
    ways), an all-to-all."""
    minor = size // major
    if not pieces:
        return (major, ()), (minor, ()), False
    n = _n(pieces)
    if major % n == 0:
        return (major, pieces), (minor, ()), False
    exact = n % major == 0
    g = major if exact else math.gcd(major, n)
    if g > 1 and minor % (n // g) == 0 and size % n == 0:
        parts = _split_pieces(pieces, g)
        if parts is not None:
            return (major, parts[0]), (minor, parts[1]), not exact
    return None


def reshape_layout(layout, out_shape):
    """(layout after a reshape to `out_shape`, whether data moves), or None
    when a sharded atom cannot follow it (the caller gathers)."""
    atoms = [a for dim in layout for a in dim]
    out, moved, i = [], False, 0
    for d in out_shape:
        if d == 1:
            out.append(())
            continue
        need, parts = d, []
        while need > 1:
            if i >= len(atoms):
                return None
            size, pieces = atoms[i]
            if need % size == 0:
                parts.append((size, pieces))
                need //= size
                i += 1
            elif size % need == 0:
                sp = _split_atom(size, pieces, need)
                if sp is None:
                    return None
                parts.append(sp[0])
                atoms[i] = sp[1]
                moved = moved or sp[2]
                need = 1
            else:
                return None
        out.append(_canon_dim(parts))
    if i != len(atoms):
        return None
    return tuple(out), moved


def _with_dims(layout, dims_to_rep) -> tuple:
    """`layout` with the dimensions in `dims_to_rep` replicated."""
    return tuple(tuple((s, ()) for s, _ in d) if i in dims_to_rep and d else d
                 for i, d in enumerate(layout))


def _unshard(dim) -> tuple:
    return _canon_dim([(s, ()) for s, _ in dim])


# --------------------------------------------------------------------------
# The trace
# --------------------------------------------------------------------------


class _Info:
    """A traced tensor's layout; `flex`: made by a creation op (or scattered
    into one) and not used yet, so `layout` is only a hint; `pending`: the
    mesh pieces over which it is still a partial sum."""

    __slots__ = ("layout", "flex", "pending")

    def __init__(self, layout, flex=False, pending=()):
        self.layout = layout
        self.flex = flex
        self.pending = pending


_CREATE = {"arange", "empty", "full", "ones", "zeros", "scalar_tensor", "new_zeros",
           "new_empty", "new_full", "new_ones", "empty_strided", "empty_permuted"}
_LIKE = {"zeros_like", "ones_like", "full_like", "empty_like"}
# unary ops a partial sum passes through
_LINEAR_UNARY = {"alias", "detach", "clone", "_to_copy", "contiguous", "neg",
                 "lift_fresh", "lift_fresh_copy"}
_ELEMENTWISE = {
    "abs", "add", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "clamp",
    "clamp_min", "clamp_max", "cos", "div", "eq", "ne", "exp", "expm1", "ge", "gt",
    "le", "lt", "log", "log1p", "log2", "logical_and", "logical_or", "logical_not",
    "maximum", "minimum", "mul", "pow", "reciprocal", "rsqrt", "rsub", "sgn", "sign",
    "sin", "sqrt", "sub", "where", "masked_fill", "masked_fill_", "sigmoid", "tanh",
    "silu", "square", "fill", "fill_", "tril", "triu", "round", "floor", "ceil", "erf",
    "relu", "threshold_backward", "sigmoid_backward", "tanh_backward", "remainder",
    "fmod", "add_", "sub_", "mul_", "div_", "copy_", "zero_", "lerp", "addcmul",
    "addcdiv", "isinf", "isnan", "isfinite", "logical_xor", "atan2", "floor_divide",
} | _LINEAR_UNARY
_SUMS = {"sum", "mean"}  # reductions a partial sum passes through
_REDUCE = {"amax", "amin", "logsumexp", "prod", "any", "all", "var", "std", "norm",
           "linalg_vector_norm", "max", "min"} | _SUMS
_FRESH: dict = {}
_TENSOR_ARGS: dict = {}


def _tensor_args(func, args, kwargs) -> list:
    """The op's tensor arguments in schema order (a list argument's
    tensors in place)."""
    spec = _TENSOR_ARGS.get(func)
    if spec is None:
        spec = _TENSOR_ARGS[func] = [(i, a.name, "List" in str(a.type))
                                     for i, a in enumerate(func._schema.arguments)
                                     if "Tensor" in str(a.type)]
    out = []
    for i, name, many in spec:
        v = args[i] if i < len(args) else kwargs.get(name)
        if many:
            out.extend(x for x in v or () if isinstance(x, torch.Tensor))
        elif isinstance(v, torch.Tensor):  # a Python scalar may stand in
            out.append(v)
    return out


def _sig(v):
    """A hashable signature of an op's arguments (a tensor by its shape,
    strides and dtype)."""
    if isinstance(v, torch.Tensor):
        return (v.shape, v.stride(), v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(_sig(x) for x in v)
    return v


def _flat_tensors(v, out: list) -> list:
    """The tensors of an op's arguments or results, in order."""
    if isinstance(v, torch.Tensor):
        out.append(v)
    elif isinstance(v, (tuple, list)):
        for x in v:
            _flat_tensors(x, out)
    elif isinstance(v, dict):
        for x in v.values():
            _flat_tensors(x, out)
    return out


class Trace(TorchDispatchMode):
    """A step's partition model on a mesh; use through `trace(mesh)`."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh_shape(mesh)
        self.order = list(self.mesh)
        self._info: dict = {}  # tensor key -> _Info
        self._storages: dict = {}  # storage cdata -> [weakref, bytes, kind, keys]
        self._arguments: set = set()  # storages of the step's arguments
        self._arg_layouts: dict = {}  # argument shape -> its layout
        self._read: set = set()  # argument storages an op has read
        self._moved: dict = {}  # key -> layouts it was resharded to (counted once)
        self._meta_cache: dict = {}
        self._bind_cache: dict = {}
        self._link_cache: dict = {}
        self._memo: dict = {}  # op and input layouts -> the rule's effects
        self._rec = None  # the effects of the rule running now
        self._io = ((), ())  # the running op's tensor inputs and outputs
        self._nested = 0
        self._kc = None  # the running op's tensor keys, by object
        self.events: list = []  # (storage serial, delta bytes)
        self._serials = 0  # storages registered so far
        self.active = True
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.collectives = dict.fromkeys(COLLECTIVES, 0.0)
        self.by_link = {"nvlink": 0.0, "network": 0.0}
        self.by_op: Counter = Counter()  # "collective op" -> bytes
        self.fallback_ops: Counter = Counter()
        self.n_ops = 0
        self._op = ""

    # -- storages and memory --------------------------------------------------

    def _key(self, t: torch.Tensor):
        """A tensor's identity: its storage, offset, shape and strides (a
        view made again, or a saved tensor unpacked, is the same tensor).
        Inside an op, remembered by object (the op holds its tensors)."""
        kc = self._kc
        if kc is not None:
            k = kc.get(id(t))
            if k is not None:
                return k
        k = (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape), t.stride())
        if kc is not None:
            kc[id(t)] = k
        return k

    def _register(self, t: torch.Tensor, key, kind: str, nbytes: float) -> None:
        st = t.untyped_storage()
        cd = st._cdata
        rec = self._storages.get(cd)
        if rec is not None:
            rec[3].append(key)
            return
        ref = weakref.ref(st, lambda _r, cd=cd: self._free(cd))
        # an address is reused once its storage is freed: events name the
        # storage by a serial number
        self._storages[cd] = [ref, 0.0, kind, [key], self._serials]
        self._serials += 1
        if nbytes:
            self._alloc(cd, nbytes)

    def _alloc(self, cd, nbytes: float) -> None:
        rec = self._storages.get(cd)
        if rec is None or rec[2] != "temp" or not nbytes:
            return
        rec[1] += nbytes
        self.events.append((rec[4], nbytes))

    def _free(self, cd) -> None:
        if not self.active:
            return
        rec = self._storages.pop(cd, None)
        if rec is None:
            return
        for k in rec[3]:  # the address may be reused: forget what it held
            self._info.pop(k, None)
            self._moved.pop(k, None)
        if rec[1]:
            self.events.append((rec[4], -rec[1]))

    @staticmethod
    def _local_bytes(t: torch.Tensor, layout) -> float:
        """A position's bytes of tensor `t` under `layout`."""
        return float(_numel(local_shape(layout)) * t.element_size())

    @staticmethod
    def _storage_bytes(t: torch.Tensor, layout) -> float:
        """A position's bytes of `t`'s storage, `t` under `layout`."""
        numel = t.numel()
        if numel == 0:
            return 0.0
        return t.untyped_storage().nbytes() * min(_numel(local_shape(layout)) / numel, 1.0)

    # -- layouts of tensors ---------------------------------------------------

    def info(self, t: torch.Tensor) -> _Info:
        key = self._key(t)
        if key[0] in self._arguments:
            self._read.add(key[0])
        inf = self._info.get(key)
        if inf is None:  # made where the trace could not see it: replicated
            inf = self._info[key] = _Info(replicated(t.shape))
        return inf

    def layout(self, t: torch.Tensor):
        return self.info(t).layout

    def spec(self, t: torch.Tensor) -> tuple:
        """The partition spec a traced tensor has now."""
        return spec_of_layout(self.layout(t), self.mesh)

    def mark_read(self, t: torch.Tensor) -> None:
        """Note that the step read argument `t` outside an op (a Python
        scalar taken from it)."""
        self.info(t)

    def read(self, tree) -> list[bool]:
        """For each argument of `tree` (in `paired` order), whether the step
        read it: XLA keeps only those (jit's keep_unused=False)."""
        return [t.untyped_storage()._cdata in self._read
                for t, _ in paired(tree, _nones(tree))]

    def place(self, tree, specs) -> None:
        """Register the step's arguments (meta tensors made outside the
        trace) under their partition specs (a tree like `tree`)."""
        for t, s in paired(tree, specs):
            lay = layout_of_spec(tuple(t.shape), s, self.mesh)
            key = self._key(t)
            self._info[key] = _Info(lay)
            self._register(t, key, "argument", 0.0)
            self._arguments.add(key[0])
            self._arg_layouts.setdefault(tuple(t.shape), lay)

    def constrain(self, x: torch.Tensor, spec) -> torch.Tensor:
        """`with_sharding_constraint`: x takes `spec`'s layout (the reshard
        counted: a pending partial sum becomes a reduce-scatter or an
        all-reduce), and comes back. Under autograd it comes back as a view
        of itself whose gradient takes the same spec, as JAX transposes the
        constraint."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Constrain.apply(x, self, spec)
        self._op = "constraint"
        self._settle(x, layout_of_spec(tuple(x.shape), spec, self.mesh), force=True)
        return x

    # -- collectives ----------------------------------------------------------

    def _link(self, pieces) -> str:
        """"nvlink" when every group of positions that varies `pieces` lies
        within one host of HOST_CARDS cards, else "network"."""
        key = tuple(sorted(set(pieces)))
        got = self._link_cache.get(key)
        if got is None:
            pos_stride, total = {}, 1
            for a in reversed(self.order):
                pos_stride[a] = total
                total *= self.mesh[a]
            offsets = [0]
            for a, size, stride in key:
                offsets = [o + d * stride * pos_stride[a] for o in offsets for d in range(size)]
            span = max(offsets)
            within = span < HOST_CARDS and all(
                base // HOST_CARDS == (base + span) // HOST_CARDS
                for base in range(total)
                if not any((base // (pos_stride[a] * stride)) % size for a, size, stride in key))
            got = self._link_cache[key] = "nvlink" if within else "network"
        return got

    def _collective(self, kind: str, nbytes: float, pieces) -> None:
        if nbytes <= 0 or not pieces:
            return
        self._record("coll", kind, nbytes, tuple(pieces))
        self.collectives[kind] += nbytes
        self.by_link[self._link(pieces)] += nbytes
        self.by_op[f"{kind} {self._op}"] += nbytes

    def _reshard(self, t: torch.Tensor, src, dst) -> None:
        """Count moving `t` from layout `src` to `dst`: a dropped sharding is
        an all-gather, a moved one an all-to-all, an added one a local
        slice (free)."""
        where_src = {p: i for i, d in enumerate(src) for p in _dim_pieces(d)}
        where_dst = {p: i for i, d in enumerate(dst) for p in _dim_pieces(d)}
        gone = [p for p in where_src if p not in where_dst]
        moved = [p for p in where_src if p in where_dst and where_src[p] != where_dst[p]]
        added = [p for p in where_dst if p not in where_src]
        nb = self._local_bytes(t, dst)
        if moved or (gone and added):
            self._collective("all-to-all", max(nb, self._local_bytes(t, src)),
                             moved + gone + added)
        elif gone:
            self._collective("all-gather", nb, gone)

    def _default(self, t: torch.Tensor, inf: _Info):
        """Where a flex tensor goes when its consumer has no say: the layout
        of an argument of its shape (a gradient meets its parameter in the
        update), else its hint."""
        return self._arg_layouts.get(tuple(t.shape), inf.layout)

    def _settle(self, t: torch.Tensor, target=None, keep: bool = False,
                force: bool = False) -> None:
        """Bring `t` to layout `target` (its own, or for a flex tensor its
        default, when None): a flex tensor is allocated there, a placed one
        resharded (once a view and layout: a reshard is reused). Its pending
        partial sum is reduced (reduce-scatter when `target` shards a pending
        piece, else all-reduce) unless `keep`. A placed tensor that needs
        only a local slice keeps its own layout, unless `force` (a
        constraint)."""
        self._record("settle", t, target, keep, force)
        self._nested += 1
        try:
            self._settle_now(t, target, keep, force)
        finally:
            self._nested -= 1

    def _settle_now(self, t: torch.Tensor, target, keep: bool, force: bool) -> None:
        key = self._key(t)
        inf = self.info(t)
        if target is None:
            target = self._default(t, inf) if inf.flex else inf.layout
        if inf.flex:
            rec = self._storages.get(key[0])
            if rec is not None and not rec[1]:
                self._alloc(key[0], self._storage_bytes(t, target))
        elif target != inf.layout and _adds_only(inf.layout, target):
            if not force:
                target = inf.layout
        elif target != inf.layout and target not in self._moved.setdefault(key, set()):
            self._moved[key].add(target)
            self._reshard(t, inf.layout, target)
        pending = inf.pending
        if pending and not keep:
            scattered = set(pending) & set(_pieces(target))
            self._collective("reduce-scatter" if scattered else "all-reduce",
                             self._local_bytes(t, target), pending)
            pending = ()
        if inf.flex or target != inf.layout or pending != inf.pending:
            self._info[key] = _Info(target, False, pending)

    # -- dispatch -------------------------------------------------------------

    def _bind(self, func, args, kwargs) -> dict:
        names = self._bind_cache.get(func)
        if names is None:
            names = self._bind_cache[func] = [
                (a.name, a.default_value if a.has_default_value() else None)
                for a in func._schema.arguments]
        out = {}
        for i, (name, default) in enumerate(names):
            out[name] = args[i] if i < len(args) else kwargs.get(name, default)
        return out

    def _run(self, func, args, kwargs):
        """func(*args, **kwargs) on meta tensors. An op that makes fresh
        tensors runs once a signature: later calls get empty tensors of the
        remembered shapes (the meta kernels of elementwise ops are Python,
        and the flash loop repeats a few signatures thousands of times)."""
        fresh = _FRESH.get(func)
        if fresh is None:
            sch = func._schema
            fresh = _FRESH[func] = (bool(sch.returns) and not sch.is_mutable and
                                    all(r.alias_info is None for r in sch.returns))
        if not fresh:
            return func(*args, **kwargs)
        try:
            sig = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
            meta = self._meta_cache.get(sig)
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        self._last_sig = sig
        if meta is None:
            out = func(*args, **kwargs)
            seq = isinstance(out, (tuple, list))
            outs = out if seq else (out,)
            if all(isinstance(o, torch.Tensor) for o in outs):
                self._meta_cache[sig] = (seq, type(out), [(tuple(o.shape), o.stride(), o.dtype)
                                                          for o in outs])
            return out
        seq, typ, specs = meta
        made = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in specs]
        return typ(made) if seq else made[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._last_sig = None
        out = self._run(func, args, kwargs)
        self.n_ops += 1
        outs = _flat_tensors(out, [])
        if not outs:
            return out
        self._kc = {}
        try:
            return self._dispatch(func, args, kwargs, out, outs)
        finally:
            self._kc = None

    def _dispatch(self, func, args, kwargs, out, outs):
        name = func.overloadpacket.__name__
        self._op = name
        ins = _tensor_args(func, args, kwargs)
        memo = self._memo_key(ins, outs)
        effects = self._memo.get(memo) if memo is not None else None
        if effects is not None:
            self._replay(effects, ins, outs)
            return out
        rule = _RULES.get(name)
        if rule is None:
            rule = (_elementwise if name in _ELEMENTWISE else _create if name in _CREATE
                    else _like if name in _LIKE else _reduce if name in _REDUCE else None)
        self._rec, self._io = ([] if memo is not None else None), (ins, outs)
        try:
            if rule is None:
                raise _Gather(listed=True)
            rule(self, name, func, args, kwargs, outs)
        except _Gather as g:
            self._fallback(name, args, kwargs, outs, g.listed)
        finally:
            # hold no tensor past the op: autograd steals buffers nobody else holds
            rec, self._rec, self._io = self._rec, None, ((), ())
        if rec is not None:
            self._memo[memo] = rec
        return out

    # -- the rules' effects, remembered by op and input layouts -----------------

    def _memo_key(self, ins, outs):
        """The op's signature (`_run`'s) with every input's layout, flex state
        and pending sum and the inputs' and outputs' aliasing: a rule's
        effects depend on nothing else. None when the op has no signature."""
        if self._last_sig is None:
            return None
        keys = [self._key(t) for t in ins]
        infos = tuple((i.layout, i.flex, i.pending) for i in map(self.info, ins))
        okeys = [self._key(o) for o in outs]
        alias = tuple(keys.index(k) if k in keys else -1 for k in okeys)
        return (self._last_sig, infos, tuple(keys.index(k) for k in keys), alias)

    def _record(self, tag, *what) -> None:
        """Note one effect of the running rule (not those inside a settle):
        tensors by their place among the op's inputs or outputs."""
        if self._rec is None or self._nested:
            return
        if tag in ("settle", "set"):
            group = self._io[0] if tag == "settle" else self._io[1]
            t = what[0]
            at = next((j for j, u in enumerate(group) if u is t), None)
            if at is None:  # a tensor the op does not hold: not replayable
                self._rec = None
                return
            what = (at,) + what[1:]
        self._rec.append((tag,) + what)

    def _replay(self, effects, ins, outs) -> None:
        for e in effects:
            tag = e[0]
            if tag == "settle":
                self._settle(ins[e[1]], *e[2:])
            elif tag == "set":
                self._set(outs[e[1]], *e[2:])
            elif tag == "coll":
                self._collective(*e[1:])
            elif tag == "dot":
                self._dot(*e[1:])
            else:
                self.fallback_ops[e[1]] += 1

    def _dot(self, flops: float, nbytes: float) -> None:
        self._record("dot", flops, nbytes)
        self.dot_flops += flops
        self.dot_bytes += nbytes

    def _set(self, t: torch.Tensor, layout, flex=False, pending=()) -> None:
        if len(layout) != t.dim():
            raise AssertionError(f"{self._op}: a layout of {len(layout)} dimensions "
                                 f"for a tensor of {t.dim()}")
        self._record("set", t, layout, flex, tuple(pending))
        key = self._key(t)
        self._info[key] = _Info(layout, flex, tuple(pending))
        rec = self._storages.get(key[0])
        if rec is not None:
            rec[3].append(key)
        else:
            self._register(t, key, "temp", 0.0 if flex else self._storage_bytes(t, layout))

    def _fallback(self, name, args, kwargs, outs, listed=True) -> None:
        """GSPMD's fallback: every input gathered, the op replicated."""
        if listed:
            self._record("fallback", name)
            self.fallback_ops[name] += 1
        out_keys = {self._key(o) for o in outs}
        for t in self._io[0]:
            if self._key(t) not in out_keys:
                self._settle(t, replicated(t.shape))
        for o in outs:
            self._set(o, replicated(o.shape))


class _Constrain(torch.autograd.Function):
    """A sharding constraint on a value and on its gradient."""

    @staticmethod
    def forward(ctx, x, tr, spec):
        ctx.tr, ctx.spec = tr, spec
        y = x.view_as(x)
        tr._op = "constraint"
        tr._settle(y, layout_of_spec(tuple(y.shape), spec, tr.mesh), force=True)
        return y

    @staticmethod
    def backward(ctx, g):
        ctx.tr._op = "constraint"
        ctx.tr._settle(g, layout_of_spec(tuple(g.shape), ctx.spec, ctx.tr.mesh), force=True)
        return g, None, None


class _Gather(Exception):
    """A rule cannot follow its inputs' sharding: gather them."""

    def __init__(self, listed: bool = False):
        super().__init__()
        self.listed = listed


def _adds_only(src, dst) -> bool:
    """Whether `dst` only adds sharding to `src` (each dim keeps its pieces
    and may gain some): a local slice."""
    if len(src) != len(dst):
        return False
    for a, b in zip(src, dst):
        pb = _dim_pieces(b)
        if any(p not in pb for p in _dim_pieces(a)):
            return False
    return True


# --------------------------------------------------------------------------
# Rules: each sets the layouts of `outs` and settles its inputs
# --------------------------------------------------------------------------


def _merge(tr: Trace, tensors, shape, skip=()) -> tuple:
    """Broadcast placed `tensors` to an output of `shape`: each dimension
    takes the most sharded operand layout of its size (larger operands
    first), no mesh piece used twice."""
    ndim = len(shape)
    dims = []
    used: list = []
    ordered = sorted(tensors, key=lambda t: -t.numel())
    lays = [(t, tr.layout(t)) for t in ordered]
    for i in range(ndim):
        best = None
        if i not in skip and shape[i] != 1:
            for t, lay in lays:
                j = i - (ndim - t.dim())
                if j < 0 or t.shape[j] != shape[i]:
                    continue
                ps = _dim_pieces(lay[j])
                if ps and not _conflicts(ps, used) and (
                        best is None or _n(ps) > _n(_dim_pieces(best))):
                    best = lay[j]
        if best is None:
            best = _rep_dim(shape[i])
        dims.append(best)
        used.extend(_dim_pieces(best))
    return tuple(dims)


def _broadcast(layout, t: torch.Tensor, out: torch.Tensor) -> tuple:
    """Operand `t`'s layout broadcast to `out`'s shape."""
    off = out.dim() - t.dim()
    return tuple(layout[i - off] if i >= off and t.shape[i - off] == out.shape[i]
                 else _rep_dim(out.shape[i]) for i in range(out.dim()))


def _project(layout, t: torch.Tensor, skip=()) -> tuple:
    """The part of an output layout that a broadcast operand `t` sees."""
    off = len(layout) - t.dim()
    return tuple(() if t.shape[j] == 1 else _rep_dim(t.shape[j]) if j + off in skip
                 else layout[j + off] for j in range(t.dim()))


def _passes(name: str, infos) -> bool:
    """Whether a partial sum passes through elementwise op `name` (each
    position may apply it to its own part): unary linear ops, a sum of
    operands partial over the same pieces, a product with one partial
    factor."""
    pend = [i.pending for i in infos if i.pending]
    if not pend:
        return True
    if name in _LINEAR_UNARY:
        return True
    if name in ("add", "sub", "add_", "sub_"):
        return len(pend) == len(infos) and all(p == pend[0] for p in pend)
    if name in ("mul", "div", "mul_", "div_"):
        return len(pend) == 1 and (name.startswith("mul") or bool(infos[0].pending))
    return False


def _elementwise(tr: Trace, name, func, args, kwargs, outs):
    ins = tr._io[0]
    out = outs[0]
    infos = [tr.info(t) for t in ins]
    passes = _passes(name, infos)
    pending = next((i.pending for i in infos if i.pending), ()) if passes else ()
    if not passes:  # partial sums reduced first, where they are
        for t, i in zip(ins, infos):
            if i.pending:
                tr._settle(t)
        infos = [tr.info(t) for t in ins]
    if name.endswith("_") and ins and tr._key(ins[0]) == tr._key(out):
        # in place: the destination decides
        if infos[0].flex:
            tr._settle(ins[0], tr._default(ins[0], infos[0]), keep=True)
        lay = tr.layout(ins[0])
        for t in ins[1:]:
            tr._settle(t, _project(lay, t), keep=passes)
        tr._set(out, lay, pending=pending)
        return
    full_flex = [t for t, i in zip(ins, infos) if i.flex and t.numel() == out.numel()]
    placed = [t for t, i in zip(ins, infos) if not i.flex]
    if all(i.flex for i in infos) or (full_flex and all(t.numel() < out.numel() for t in placed)):
        # no placed operand of the output's size: the output stays flex (a
        # creation op's value, or a scattered gradient on its way to its
        # consumer)
        hint = _broadcast(tr.info(full_flex[0]).layout, full_flex[0], out) if full_flex \
            else replicated(out.shape)
        for o in outs:
            tr._set(o, hint, True, pending)
        return
    lay = _merge(tr, placed, tuple(out.shape))
    for t in ins:
        tr._settle(t, _project(lay, t), keep=passes)
    for o in outs:
        tr._set(o, lay, pending=pending)


def _create(tr: Trace, name, func, args, kwargs, outs):
    for o in outs:
        tr._set(o, replicated(o.shape), True)


def _like(tr: Trace, name, func, args, kwargs, outs):
    inf = tr.info(args[0])
    for o in outs:
        tr._set(o, inf.layout, inf.flex)


def _carry(tr: Trace, x, outs, layout_of) -> None:
    """Views: each output's layout from `layout_of(out, x's layout)`; the
    flex state and pending sum go along."""
    inf = tr.info(x)
    for o in outs:
        tr._set(o, layout_of(o, inf.layout), inf.flex, inf.pending)


def _norm_dims(dims, ndim) -> list:
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return list(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    return sorted({d % ndim for d in dims}) if ndim else []


def _reduce(tr: Trace, name, func, args, kwargs, outs):
    """A reduction: over a sharded dimension, a sum (mean) becomes partial
    (pending), any other reduction an all-reduce of its output (logsumexp
    two: a max and a sum)."""
    b = tr._bind(func, args, kwargs)
    x = b["self"]
    dims = _norm_dims(b.get("dim"), x.dim())
    keep = bool(b.get("keepdim", False))
    inf = tr.info(x)
    linear = name in _SUMS
    if inf.pending and not linear:
        tr._settle(x)
        inf = tr.info(x)
    red = [p for i in dims for p in _dim_pieces(inf.layout[i])] if not inf.flex else []
    lay = tuple(() if i in dims else d for i, d in enumerate(inf.layout)
                if keep or i not in dims)
    for o in outs:
        ol = lay if o.dim() == len(lay) else replicated(o.shape)
        if inf.flex:
            tr._set(o, ol, True, inf.pending)
        elif linear:
            tr._set(o, ol, pending=tuple(inf.pending) + tuple(red))
        else:
            tr._set(o, ol)
            nb = tr._local_bytes(o, ol)
            for _ in range(2 if name == "logsumexp" else 1 if red else 0):
                tr._collective("all-reduce", nb, red)


def _view(tr: Trace, name, func, args, kwargs, outs):
    """A reshape moves the atoms (`reshape_layout`); where a sharded
    dimension cannot follow, that dimension alone is gathered first."""
    x = args[0]
    shape = tuple(outs[0].shape)
    inf = tr.info(x)
    got = reshape_layout(inf.layout, shape)
    if got is None and not inf.flex:
        sharded = [i for i, d in enumerate(inf.layout) if _dim_pieces(d)]
        for dims in [{i} for i in reversed(sharded)] + [set(sharded)]:
            trial = _with_dims(inf.layout, dims)
            got = reshape_layout(trial, shape)
            if got is not None:
                tr._settle(x, trial, keep=True)
                break
    if got is None:
        got = (replicated(shape), False)
    lay, moved = got
    if moved and not inf.flex:
        tr._collective("all-to-all", tr._local_bytes(x, tr.layout(x)), _pieces(lay))
    _carry(tr, x, outs, lambda o, _l: lay)


def _permute(tr: Trace, name, func, args, kwargs, outs):
    x = args[0]
    nd = x.dim()
    if name == "permute":
        order = [d % nd for d in args[1]]
    elif name == "t":
        order = [1, 0] if nd == 2 else list(range(nd))
    else:  # transpose
        b = tr._bind(func, args, kwargs)
        order = list(range(nd))
        d0, d1 = b["dim0"] % nd, b["dim1"] % nd
        order[d0], order[d1] = order[d1], order[d0]
    _carry(tr, x, outs, lambda o, lay: tuple(lay[i] for i in order))


def _unsqueeze(tr: Trace, name, func, args, kwargs, outs):
    d = args[1] % (args[0].dim() + 1)
    _carry(tr, args[0], outs, lambda o, lay: lay[:d] + ((),) + lay[d:])


def _squeeze(tr: Trace, name, func, args, kwargs, outs):
    _carry(tr, args[0], outs,
           lambda o, lay: (reshape_layout(lay, tuple(o.shape)) or (replicated(o.shape),))[0])


def _expand(tr: Trace, name, func, args, kwargs, outs):
    x = args[0]

    def lay_of(o, lay):
        off = o.dim() - x.dim()
        return tuple([_rep_dim(s) for s in o.shape[:off]] +
                     [d if x.shape[j] == o.shape[off + j] else _rep_dim(o.shape[off + j])
                      for j, d in enumerate(lay)])

    _carry(tr, x, outs, lay_of)


def _slice_layout(tr: Trace, x, dim: int, o) -> tuple:
    """The layout of `o`, a slice of `x` along `dim`: a slice of a sharded
    dimension stays sharded where its length allows (rebalanced: a
    collective-permute), else it is gathered."""
    inf = tr.info(x)
    lay = list(inf.layout)
    ps = _dim_pieces(lay[dim])
    m = o.shape[dim]
    if not ps or inf.flex:
        lay[dim] = _rep_dim(m)
    elif m != x.shape[dim]:
        lay[dim] = ((m, ps),) if m % _n(ps) == 0 else _rep_dim(m)
        kind = "collective-permute" if m % _n(ps) == 0 else "all-gather"
        tr._collective(kind, tr._local_bytes(o, tuple(lay)), ps)
    return tuple(lay)


def _slice(tr: Trace, name, func, args, kwargs, outs):
    b = tr._bind(func, args, kwargs)
    x = b["self"]
    dim = (b.get("dim") or 0) % x.dim()
    _carry(tr, x, outs, lambda o, _l: _slice_layout(tr, x, dim, o))


def _select(tr: Trace, name, func, args, kwargs, outs):
    """select / unbind: a sharded dimension's slice is broadcast from its
    owner (an all-reduce)."""
    b = tr._bind(func, args, kwargs)
    x = b["self"]
    dim = (b.get("dim") or 0) % x.dim()
    inf = tr.info(x)
    ps = () if inf.flex else _dim_pieces(inf.layout[dim])
    lay = inf.layout[:dim] + inf.layout[dim + 1:]
    _carry(tr, x, outs, lambda o, _l: lay)
    for o in outs:
        tr._collective("all-reduce", tr._local_bytes(o, lay), ps)


def _into(tr: Trace, name, func, args, kwargs, outs):
    """select_backward / slice_backward: the gradient written into zeros of
    the input's shape."""
    b = tr._bind(func, args, kwargs)
    g, out = b["grad_output"], outs[0]
    dim = b["dim"] % out.dim()
    lay = list(tr.layout(g))
    if name == "select_backward":
        lay.insert(dim, _rep_dim(out.shape[dim]))
    else:
        ps = _dim_pieces(lay[dim])
        lay[dim] = ((out.shape[dim], ps),) if ps else _rep_dim(out.shape[dim])
        tr._collective("collective-permute", tr._local_bytes(out, tuple(lay)), ps)
    _carry(tr, g, outs, lambda o, _l: tuple(lay))


def _cat(tr: Trace, name, func, args, kwargs, outs):
    b = tr._bind(func, args, kwargs)
    out = outs[0]
    ts = [t for t in b["tensors"] if t.numel() or t.dim() > 1]
    dim = (b.get("dim") or 0) % out.dim()
    for t in ts:
        if tr.info(t).flex or tr.info(t).pending:
            tr._settle(t)
    if name == "stack":
        inner = tuple(out.shape[:dim]) + tuple(out.shape[dim + 1:])
        lay = _merge(tr, ts, inner)
        for t in ts:
            tr._settle(t, _project(lay, t))
        lay = lay[:dim] + (_rep_dim(out.shape[dim]),) + lay[dim:]
    else:
        lay = _merge(tr, ts, tuple(out.shape), skip=(dim,))
        for t in ts:
            tr._settle(t, _project(lay, t, skip=(dim,)))
    tr._set(out, lay)


def _split(tr: Trace, name, func, args, kwargs, outs):
    b = tr._bind(func, args, kwargs)
    x = b["self"]
    dim = (b.get("dim") or 0) % x.dim()
    _carry(tr, x, outs, lambda o, _l: _slice_layout(tr, x, dim, o))


def _pad(tr: Trace, name, func, args, kwargs, outs):
    x, pad = args[0], list(args[1])
    padded = {x.dim() - 1 - i // 2 for i in range(len(pad)) if pad[i]}
    inf = tr.info(x)
    if not inf.flex and any(_dim_pieces(inf.layout[d]) for d in padded):
        tr._settle(x, _with_dims(inf.layout, padded), keep=True)
    _carry(tr, x, outs, lambda o, lay: tuple(_rep_dim(o.shape[i]) if i in padded else d
                                             for i, d in enumerate(lay)))


def _flip(tr: Trace, name, func, args, kwargs, outs):
    """A flip of a sharded dimension swaps the positions' parts: a
    collective-permute."""
    x = args[0]
    inf = tr.info(x)
    dims = _norm_dims(list(args[1]), x.dim())
    _carry(tr, x, outs, lambda o, lay: lay)
    if not inf.flex:
        ps = [p for d in dims for p in _dim_pieces(inf.layout[d])]
        tr._collective("collective-permute", tr._local_bytes(outs[0], inf.layout), ps)


def _along(tr: Trace, name, func, args, kwargs, outs):
    """cumsum / sort along a dimension: a sharded one is gathered first."""
    b = tr._bind(func, args, kwargs)
    x = b["self"]
    dim = b.get("dim", -1) % x.dim()
    tr._settle(x)
    lay = tr.layout(x)
    if _dim_pieces(lay[dim]):
        tr._settle(x, _with_dims(lay, {dim}))
    for o in outs:
        tr._set(o, tr.layout(x))


def _dot(tr: Trace, name, func, args, kwargs, outs):
    """mm / bmm / addmm / baddbmm over labels b (batch), m, k (contracted),
    n. The larger operand keeps its layout (its labels first), the other
    is resharded to match; a sharded k is a partial sum (pending)."""
    out = outs[0]
    bias, a, w = (args[0], args[1], args[2]) if name in ("addmm", "baddbmm") \
        else (None, args[0], args[1])
    batched = a.dim() == 3
    la_names, lw_names = ("bmk", "bkn") if batched else ("mk", "kn")
    sizes = {"m": a.shape[-2], "k": a.shape[-1], "n": w.shape[-1], "b": a.shape[0]}
    for t in (a, w):
        if tr.info(t).pending:
            tr._settle(t)
    la = {c: (None if tr.info(a).flex else d) for c, d in zip(la_names, tr.layout(a))}
    lw = {c: (None if tr.info(w).flex else d) for c, d in zip(lw_names, tr.layout(w))}
    big_is_a = a.numel() >= w.numel()
    big, small = (la, lw) if big_is_a else (lw, la)
    choice, used = {}, []
    for lab in ("b", "k", "m", "n") if big_is_a else ("b", "k", "n", "m"):
        pick = next((d for d in (big.get(lab), small.get(lab))
                     if d is not None and not _conflicts(_dim_pieces(d), used)), None)
        choice[lab] = pick if pick is not None else _rep_dim(sizes[lab])
        used.extend(_dim_pieces(choice[lab]))
    ta = tuple(choice[c] for c in la_names)
    tw = tuple(choice[c] for c in lw_names)
    tr._settle(a, ta)
    tr._settle(w, tw)
    lay = tuple(choice[c] for c in (("bmn") if batched else "mn"))
    if bias is not None:
        tr._settle(bias, _project(lay, bias))
    tr._set(out, lay, pending=_dim_pieces(choice["k"]))
    sa, sw, so = local_shape(ta), local_shape(tw), local_shape(lay)
    flop = {"mm": lambda: FC.mm_flop(sa, sw), "bmm": lambda: FC.bmm_flop(sa, sw),
            "addmm": lambda: FC.addmm_flop(so, sa, sw),
            "baddbmm": lambda: FC.baddbmm_flop(so, sa, sw)}[name]
    tr._dot(flop(), _numel(sa) * a.element_size() + _numel(sw) * w.element_size()
            + _numel(so) * out.element_size())


def _masked(tr: Trace, out, lay, pieces) -> tuple:
    """The pending pieces of a masked local gather from a dimension sharded
    on `pieces` into an output of layout `lay`: a piece the output is
    sharded on holds other rows on each position (an all-to-all brings
    them), the rest sum partial results."""
    used = set(_pieces(lay))
    moved = [p for p in pieces if p in used]
    if moved:
        tr._collective("all-to-all", tr._local_bytes(out, lay), moved)
    return tuple(p for p in pieces if p not in used)


def _embedding(tr: Trace, name, func, args, kwargs, outs):
    """Lookups in a table sharded over its rows: masked local lookups,
    partial over the table's pieces."""
    w, idx, out = args[0], args[1], outs[0]
    tr._settle(idx)
    tr._settle(w)
    ilay, wlay = tr.layout(idx), tr.layout(w)
    dlay = wlay[1] if not _conflicts(_dim_pieces(wlay[1]), _pieces(ilay)) else _unshard(wlay[1])
    lay = ilay + (dlay,)
    tr._set(out, lay, pending=_masked(tr, out, lay, _dim_pieces(wlay[0])))


def _embedding_backward(tr: Trace, name, func, args, kwargs, outs):
    """The table's gradient: rows scattered from every batch position, flex
    and partial over the batch's pieces."""
    g, idx, out = args[0], args[1], outs[0]
    tr._settle(idx)
    gi = tr.info(g)
    hint = (_rep_dim(out.shape[0]), _rep_dim(out.shape[1]) if gi.flex else gi.layout[-1])
    tr._set(out, hint, True, tuple(_pieces(tr.layout(idx))) + tuple(gi.pending))


def _gather(tr: Trace, name, func, args, kwargs, outs):
    """torch.gather: the index's layout; a sharded gathered dimension is a
    masked local gather, partial over its pieces."""
    b = tr._bind(func, args, kwargs)
    x, idx, out = b["self"], b["index"], outs[0]
    dim = b["dim"] % x.dim()
    tr._settle(x)
    tr._settle(idx)
    lay = _merge(tr, [x, idx], tuple(out.shape), skip=(dim,))
    tr._settle(idx, _project(lay, idx))
    xt = list(_project(lay, x, skip=(dim,)))
    gathered = _dim_pieces(tr.layout(x)[dim])
    if gathered and not _conflicts(gathered, _pieces(lay)):
        xt[dim] = tr.layout(x)[dim]
    else:
        gathered = ()
    tr._settle(x, tuple(xt))
    tr._set(out, lay, pending=_masked(tr, out, lay, gathered))


def _index_select(tr: Trace, name, func, args, kwargs, outs):
    b = tr._bind(func, args, kwargs)
    x, idx = b["self"], b["index"]
    dim = b["dim"] % x.dim()
    tr._settle(x)
    tr._settle(idx)
    lay = list(tr.layout(x))
    ps = _dim_pieces(lay[dim])
    lay[dim] = tr.layout(idx)[0] if idx.dim() else ()
    tr._set(outs[0], tuple(lay), pending=_masked(tr, outs[0], tuple(lay), ps))


def _index(tr: Trace, name, func, args, kwargs, outs):
    """Advanced indexing x[i0, i1, ...] (None = every row of that
    dimension): the indices' layout in place of the indexed dimensions;
    sharded indexed dimensions are masked local gathers (partial)."""
    x, indices, out = args[0], list(args[1]), outs[0]
    tr._settle(x)
    xl = tr.layout(x)
    pos = [i for i, t in enumerate(indices) if t is not None]
    idx = [indices[i] for i in pos]
    for t in idx:
        tr._settle(t)
    ilay = _merge(tr, idx, tuple(torch.broadcast_shapes(*[t.shape for t in idx])))
    for t in idx:
        tr._settle(t, _project(ilay, t))
    if pos == list(range(pos[0], pos[0] + len(pos))):
        lay = tuple(xl[:pos[0]]) + ilay + tuple(xl[pos[-1] + 1:])
    else:
        lay = ilay + tuple(d for i, d in enumerate(xl) if i not in pos)
    if len(lay) != out.dim():
        raise _Gather
    tr._set(out, lay, pending=_masked(tr, out, lay, [p for i in pos for p in _dim_pieces(xl[i])]))


def _scatter(tr: Trace, name, func, args, kwargs, outs):
    """scatter / scatter_add / index_add / index_put: rows of the source land
    at data-dependent places of the destination, so sharded source rows
    make the result partial over their pieces (pending)."""
    b = tr._bind(func, args, kwargs)
    x, out = b["self"], outs[0]
    src = next((b[k] for k in ("src", "source", "values") if isinstance(b.get(k), torch.Tensor)),
               None)
    if name.startswith("index_put"):
        rows = max((t.dim() for t in b["indices"] if t is not None), default=0)
        src_dims = list(range(rows))
    else:
        src_dims = [b["dim"] % x.dim()]
    partial = ()
    if src is not None:
        si = tr.info(src)
        if si.flex:
            tr._settle(src)
            si = tr.info(src)
        partial = tuple(p for d in src_dims if d < src.dim()
                        for p in _dim_pieces(si.layout[d])) + tuple(si.pending)
    xi = tr.info(x)
    tr._set(out, xi.layout, xi.flex, tuple(xi.pending) + partial)


_RULES = {
    "view": _view, "_unsafe_view": _view, "reshape": _view, "_reshape_alias": _view,
    "permute": _permute, "transpose": _permute, "t": _permute,
    "unsqueeze": _unsqueeze, "squeeze": _squeeze, "expand": _expand,
    "slice": _slice, "select": _select, "unbind": _select,
    "select_backward": _into, "slice_backward": _into,
    "cat": _cat, "stack": _cat, "split": _split, "split_with_sizes": _split,
    "constant_pad_nd": _pad, "flip": _flip, "cumsum": _along, "sort": _along,
    "mm": _dot, "bmm": _dot, "addmm": _dot, "baddbmm": _dot,
    "embedding": _embedding, "embedding_dense_backward": _embedding_backward,
    "gather": _gather, "index_select": _index_select, "index": _index,
    "scatter": _scatter, "scatter_add": _scatter, "index_add": _scatter,
    "index_put": _scatter, "scatter_": _scatter, "scatter_add_": _scatter,
    "index_add_": _scatter, "index_put_": _scatter,
}


@contextlib.contextmanager
def trace(mesh):
    """Run the body under the partition model of `mesh` (a `dist.mesh.Mesh`
    or an {axis: size} dict); yields the `Trace`."""
    tr = Trace(mesh)
    _STACK.append(tr)
    # Python's cycle collector frees what it frees when it runs; off, the
    # storages' lifetimes (and so the peak and autograd's buffer reuse) are
    # the same in every run.
    was = gc.isenabled()
    gc.disable()
    try:
        with tr:
            yield tr
    finally:
        _STACK.pop()
        if was:
            gc.enable()


def summary(tr: Trace, outputs=()) -> dict:
    """The trace's counts under `hlo_analysis.analyze`'s keys, and the
    memory the step makes: `temp_bytes_peak` (its live local bytes at
    their peak, the step's `outputs` apart) and `output_bytes`."""
    out_storages, out_bytes = set(), 0.0
    for t in _flat_tensors(outputs, []):
        tr._settle(t)
        rec = tr._storages.get(t.untyped_storage()._cdata)
        if rec is not None and rec[4] not in out_storages:
            out_storages.add(rec[4])
            out_bytes += tr._local_bytes(t, tr.layout(t))
    live = peak = 0.0
    for serial, delta in tr.events:
        if serial not in out_storages:
            live += delta
            peak = max(peak, live)
    tr.active = False
    return {
        "dot_flops_per_device": tr.dot_flops,
        "dot_bytes_per_device": tr.dot_bytes,
        "collective_bytes_per_device": dict(tr.collectives),
        "collective_bytes_total": sum(tr.collectives.values()),
        "collective_bytes_by_link": dict(tr.by_link),
        "collective_bytes_by_op": dict(sorted(tr.by_op.items())),
        "temp_bytes_peak": peak,
        "output_bytes": out_bytes,
        "n_ops": tr.n_ops,
        "fallback_ops": dict(sorted(tr.fallback_ops.items())),
    }
