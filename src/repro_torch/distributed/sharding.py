"""Sharding rules (``repro.distributed.sharding`` counterpart): FSDP over
the data axes x TP over the model axis (+EP for MoE experts), applied by
param-path pattern.

Conventions (the JAX package's):
  * projections writing model-parallel features (wq/wk/wv/up/gate/...):
      (in, out) -> P(data_axes, "model")      [FSDP on in, TP on out]
  * projections reading model-parallel features (wo/down/out_proj):
      (in, out) -> P("model", data_axes)
  * expert-stacked MoE weights: expert dim over "model" (expert parallelism)
  * embeddings / LM head: vocab over "model", d_model over data (FSDP)
  * 1-D params (norm scales, biases, gates): replicated
  * stacked repeat params get a leading None for the repeat axis (any rank
    excess over the rule's rank is padded with None on the left)

A spec is the port's `PartitionSpec`: a tuple with one entry per tensor
dim, each None, a mesh axis name or a tuple of names, so that it compares
with the JAX package's ``PartitionSpec`` as a tuple.  The spec functions
read axis sizes from a ``torch.distributed`` ``DeviceMesh`` or from a
plain `MeshShape` (names and sizes, no devices), so that the production
mesh's specs can be computed on one host.  `shardings_for_params` /
`shardings_for_tree` turn specs into DTensor placements (``Shard(d)`` /
``Replicate()``, one per mesh dim) on a real ``DeviceMesh``.

`set_mesh_axes` / `constrain` let model code place activation constraints
without importing mesh machinery: with no axes configured, or on a tensor
that is not a DTensor, `constrain` returns its input, so the same model
code runs unsharded.

Where DTensor, which propagates layouts as they come where XLA chooses
them, cannot run the models' ops as written, the models call the layout
helpers below at that point; each is the plain op on a plain tensor:
`splittable` (a dim split into heads that its shards do not divide is
gathered), `merged` (heads merged back, inner shards gathered),
`attention_shards` (attention on each device's batch and head shards),
`per_batch_shard` (a sequential scan on each batch shard), `write_slice`
(a cache write into a sequence-sharded buffer, per shard) and
`elementwise` (an op DTensor has no strategy for, on the local shard).
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import tree as _tree

_AXES: dict = {"dp": None, "tp": None, "mesh": None}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` as a plain tuple of per-dim axes,
    normalized as JAX's: a one-name tuple is the name, an empty one
    None."""

    def __new__(cls, *parts):
        def norm(a):
            if isinstance(a, (tuple, list)):
                return None if not a else a[0] if len(a) == 1 else tuple(a)
            return a
        return super().__new__(cls, tuple(norm(a) for a in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices.  ``shape`` maps each
    name to its size, as a JAX mesh's ``shape`` does."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))


def _sizes(mesh) -> dict:
    """{axis name: size} of a `MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def set_mesh_axes(dp: Tuple[str, ...], tp: str, mesh=None):
    _AXES["dp"], _AXES["tp"], _AXES["mesh"] = tuple(dp), tp, mesh


def clear_mesh_axes():
    _AXES["dp"], _AXES["tp"], _AXES["mesh"] = None, None, None


def axes_configured() -> bool:
    return _AXES["dp"] is not None


def dp_axes() -> Tuple[str, ...]:
    return _AXES["dp"]


def tp_axis() -> str:
    return _AXES["tp"]


_ACTIVATION_SPECS = {
    # residual stream: batch over data and features over model
    "act": lambda dp, tp: (dp, None, tp),                # (B, S, D)
    "act_rep": lambda dp, tp: (dp, None, None),          # (B, S, D)
    "moe_grouped": lambda dp, tp: (dp, None, tp, None),  # (G, T, E, C)
    "moe_expert": lambda dp, tp: (dp, tp, None, None),   # (G, E, C, D)
}


def constrain(x, kind: str):
    """Activation sharding constraint: a DTensor ``x`` is redistributed to
    the placements of ``kind``'s spec (axes that do not divide their dim,
    or a dim of 1, dropped); without configured axes, or on any other
    tensor, ``x`` is returned as it is."""
    if not axes_configured():
        return x
    if not isinstance(x, DTensor):
        return x
    spec = _ACTIVATION_SPECS[kind](_AXES["dp"], _AXES["tp"])
    if x.ndim < len(spec):
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    mesh = x.device_mesh
    spec = tuple(a if _divides(mesh, a, d) and d > 1 else None
                 for a, d in zip(spec, x.shape))
    return _reduced(x).redistribute(mesh, placements(mesh, P(*spec)))


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicated(x):
    """DTensor ``x`` whole on every device; any other tensor as it is."""
    if not is_dtensor(x):
        return x
    return _replicated(x, list(range(x.device_mesh.ndim)))


def contiguous(x):
    """``x`` contiguous; a DTensor with a contiguous local shard (DTensor's
    own ``contiguous`` reads the global strides, which a shard left
    strided by a collective may not share)."""
    if not is_dtensor(x):
        return x.contiguous()
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=_contiguous(x.shape))


def settled(x):
    """DTensor ``x`` with its pending sums reduced; any other tensor as it
    is.  A projection's output is settled so that no later op asks for a
    shard to become a pending sum, which DTensor does not do in every
    version."""
    return _reduced(x) if is_dtensor(x) else x


def _reduced(x):
    """DTensor ``x`` with its pending sums reduced (replicated): the
    backward of a redistribution from a sum to a shard goes from the
    shard to a sum, which DTensor does not do in every version."""
    return _replicated(x, [i for i, p in enumerate(x.placements)
                           if isinstance(p, Partial)])


def _replicated(x, mesh_dims):
    """DTensor ``x`` with the mesh dims ``mesh_dims`` replicated."""
    if not mesh_dims:
        return x
    pl = list(x.placements)
    for i in mesh_dims:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def splittable(x, n: int, dim: int = -1):
    """``x`` ready for its dim ``dim`` to be split into ``(n, -1)``
    (heads): a DTensor whose ``dim`` is sharded over mesh dims whose sizes
    do not divide ``n`` gets those mesh dims replicated first, since
    DTensor refuses to split such a shard (XLA's partitioner gathers there
    too); any other tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    dims = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    if n % math.prod(x.device_mesh.size(i) for i in dims) == 0:
        return x
    return _replicated(x, dims)


def merged(x, shape, n: int):
    """``x.reshape(shape)``, which merges x's trailing dims, the first of
    them of size ``n`` (heads), into its last.  On a DTensor, the mesh
    dims that shard an inner merged dim are replicated first (DTensor
    either refuses that merge or makes a strided shard of it, whose every
    redistribution it plans by a search that costs seconds on a 3-D
    mesh), and in the backward pass the gradient gets `splittable`
    (``n``), so that the reshape's own backward can split it again.  Any
    other tensor: ``x.reshape(shape)``."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    first = len(shape) - 1
    x = _replicated(x, [i for i, p in enumerate(x.placements)
                        if isinstance(p, Shard) and p.dim > first])
    y = x.reshape(shape)
    return _SplittableGrad.apply(y, n) if y.requires_grad else y


class _SplittableGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient `splittable`."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, ctx.n), None


def attention_shards(fn, q, k, v):
    """``fn(q, k, v)`` of an attention that runs per (batch, query head)
    on whole sequences and head dims: q (B, Sq, KVH, G, D), k, v (B, Sk,
    KVH, D) -> (B, Sq, KVH, G, Dv).  On DTensors, each mesh dim shards
    the batch where it divides, else the KV heads of all three where they
    divide, else q's groups G (k and v replicated); a mesh dim that
    divides neither but the KVH x G heads into blocks inside one KV head
    (yi-9b's 4 x 8 over 16) gives each device its block of heads, with
    the KV head that block reads, and gathers the outputs.  ``fn`` runs on each device's shards (a
    chunk loop or a kernel on plain tensors).  Plain tensors: ``fn(q, k,
    v)``."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    B, Sq, KVH, G, D = q.shape
    left = {0: B, 2: KVH, 3: G}
    qpl, kvpl, block = [], [], None
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        # the batch first: a replicated q (a decode step's) slices for free
        want = [0] if isinstance(p, Shard) and p.dim == 0 else [0, 2, 3]
        dim = next((d for d in want if left[d] % n == 0), None)
        if dim is None and len(want) > 1 and block is None and \
                left[2] == KVH and left[3] == G and KVH * G % n == 0 and \
                G % (KVH * G // n) == 0:
            block = i
        if dim is not None:
            left[dim] //= n
        qpl.append(Replicate() if dim is None else Shard(dim))
        kvpl.append(Shard(dim) if dim in (0, 2) else Replicate())
    q = _reduced(q).redistribute(mesh, qpl)
    k, v = (_reduced(t).redistribute(mesh, kvpl) for t in (k, v))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if block is None:
        out = fn(ql, kl, vl).contiguous()
        shape = tuple(q.shape[:-1]) + (v.shape[-1],)
        return DTensor.from_local(out, mesh, qpl, run_check=False,
                                  shape=shape, stride=_contiguous(shape))
    # this device's block of h heads of the flattened KVH x G, inside one
    # KV head (G is a multiple of h: the mesh dim divides neither KVH nor
    # G)
    h = KVH * G // mesh.size(block)
    h0 = mesh.get_coordinate()[block] * h
    kv = slice(h0 // G, h0 // G + 1)
    out = fn(ql[:, :, kv, h0 % G:h0 % G + h], kl[:, :, kv], vl[:, :, kv])
    out = out.reshape(out.shape[0], Sq, h, out.shape[-1]).contiguous()
    pl = list(qpl)
    pl[block] = Shard(2)
    shape = (B, Sq, KVH * G, out.shape[-1])
    out = DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                             stride=_contiguous(shape))
    return _replicated(out, [block]).reshape(B, Sq, KVH, G, shape[-1])


def write_slice(buf, dim: int, start: int, val):
    """``buf.narrow(dim, start, n).copy_(val)`` (n ``val``'s size on
    ``dim``), in place.  On a DTensor ``buf`` each device writes the part
    of ``val`` that falls in its own shard of ``dim``, with ``val`` laid
    out as ``buf`` on every other dim: DTensor itself would gather a
    sliced shard and write into the copy.  Returns ``buf``."""
    n = val.shape[dim]
    if not isinstance(buf, DTensor):
        buf.narrow(dim, start, n).copy_(val)
        return buf
    mesh = buf.device_mesh
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    val = _reduced(val).redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in buf.placements]).to_local()
    # this device's range of ``dim``: the shards of the mesh dims that
    # split it, in mesh-dim order (even: the specs divide their dims)
    size, offset, coord = buf.shape[dim], 0, mesh.get_coordinate()
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            offset += coord[i] * size
    lo, hi = max(start, offset), min(start + n, offset + size)
    if hi > lo:
        buf.to_local().narrow(dim, lo - offset, hi - lo).copy_(
            val.narrow(dim, lo - start, hi - lo))
    return buf


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` of its
    local shard under the same placements (for ops DTensor has no
    strategy for, e.g. ``log_sigmoid``; a pending sum is reduced first).
    Any other tensor: ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = _reduced(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def per_batch_shard(fn, batched, shared=()):
    """``fn(batched, shared)``: ``batched`` a tuple of tensors with the
    batch on dim 0, ``shared`` one of tensors without.  When ``batched``
    holds a DTensor, every batched tensor is laid out on dim 0 as the
    first DTensor is (replicated elsewhere), every shared one replicated,
    and ``fn`` runs on the local shards: a sequential scan then runs as
    plain ops on each device, not step by step as DTensor ops (each costs
    milliseconds of host time).  ``fn`` returns a tuple of batch-first
    tensors, rewrapped as DTensors of the batch's placements."""
    lead = next((t for t in batched if isinstance(t, DTensor)), None)
    if lead is None:
        return fn(batched, shared)
    mesh = lead.device_mesh
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in lead.placements]
    rep = [Replicate()] * mesh.ndim

    def local(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return _reduced(t).redistribute(mesh, placements).to_local()
    outs = fn(tuple(local(t, batch) for t in batched),
              tuple(local(t, rep) for t in shared))
    n = math.prod(mesh.size(i) for i, p in enumerate(batch)
                  if isinstance(p, Shard))

    def wrap(o):
        shape = (o.shape[0] * n,) + tuple(o.shape[1:])
        return DTensor.from_local(o.contiguous(), mesh, batch,
                                  run_check=False,
                                  shape=shape, stride=_contiguous(shape))
    return tuple(wrap(o) for o in outs)


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


# ------------------------------------------------------------- param rules

# (regex on 'a/b/c' path string, spec builder for the LAST dims)
def _param_rules(dp, tp):
    return [
        (r"(wq|wk|wv|w_if|w_in|in_proj|kv_a|kv_b)/w(_q)?$", (dp, tp)),
        (r"(up|gate)/w(_q)?$", (dp, tp)),
        (r"(wo|down|out_proj)/w(_q)?$", (tp, dp)),
        (r"head/w(_q)?$", (dp, tp)),
        (r"\bemb$", (tp, dp)),
        (r"moe/(up|gate)$", (tp, dp, None)),     # (E, D, F): EP on E
        (r"moe/down$", (tp, None, dp)),          # (E, F, D)
        (r"router/w$", (None, None)),
        (r"shared/(up|gate)/w(_q)?$", (dp, tp)),
        (r"shared/down/w(_q)?$", (tp, dp)),
        (r"w[qkv]_bd$", (None, None, tp)),  # mlstm block-diag (H,hd,hd)
        (r"/r$", (None, None, None)),  # slstm recurrent (H,hd,4hd): replicate
                                       # (sharding hd forces a per-step
                                       #  reshard of the carry)
        (r"conv_w$", (None, None)),
    ]


def _path_str(path) -> str:
    """A path of dict keys and sequence indices as ``"a/0/b"``."""
    return "/".join(str(p) for p in path)


def _divides(mesh, axes, size: int) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = _sizes(mesh)
    return size % math.prod(sizes[a] for a in names) == 0


def param_spec(mesh, path_str: str, shape, dp, tp) -> PartitionSpec:
    """Spec for one param leaf; falls back to replication on any
    divisibility mismatch (correct, just less sharded)."""
    if len(shape) <= 1:
        return P()
    for pat, spec in _param_rules(dp, tp):
        if re.search(pat, path_str):
            spec = tuple(spec)
            if len(spec) > len(shape):
                return P()
            full = (None,) * (len(shape) - len(spec)) + spec
            # verify divisibility per dim; drop axis if mismatched
            fixed = []
            for dim, axes in zip(shape, full):
                fixed.append(axes if _divides(mesh, axes, dim) else None)
            return P(*fixed)
    return P()


def placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, axes in enumerate(spec) if axes is not None and
                name in ((axes,) if isinstance(axes, str) else axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shardings_for_params(mesh, params, dp, tp):
    """Tree of DTensor placements (of `param_spec`) matching a tree of
    params."""
    return _tree.unflatten(params, [
        placements(mesh, param_spec(mesh, _path_str(path),
                                    tuple(leaf.shape), dp, tp))
        for path, leaf in _tree.leaves_with_paths(params)])


# --------------------------------------------------------------- input rules

def batch_spec(mesh, shape, dp) -> PartitionSpec:
    """(B, ...) arrays: shard batch over the data axes if divisible."""
    if len(shape) == 0:
        return P()
    if _divides(mesh, dp, shape[0]) and shape[0] > 1:
        return P(dp, *((None,) * (len(shape) - 1)))
    return P()


def cache_leaf_spec(mesh, shape, dp, tp) -> PartitionSpec:
    """KV-cache / recurrent-state leaves.

    Layout conventions: (R, B, S, KVH, hd) stacked KV, (B, S, KVH, hd)
    unstacked, (R, B, S, L) MLA latent, SSM states (R, B, H, hd, N)...
    Strategy: shard the batch dim over dp when divisible; then shard the
    largest remaining dim that the model axis divides (prefer heads, then
    sequence) over tp.
    """
    nd = len(shape)
    spec = [None] * nd
    # find batch dim: first dim whose index is 0 (unstacked) or 1 (stacked)
    bdim = 1 if nd >= 2 and shape[0] <= 64 and nd >= 4 else 0
    if _divides(mesh, dp, shape[bdim]) and shape[bdim] > 1:
        spec[bdim] = dp
    tp_size = _sizes(mesh)[tp]
    # prefer a heads-like or large dim for tp
    order = sorted(range(nd), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % tp_size == 0 and shape[i] > 1:
            spec[i] = tp
            break
    return P(*spec)


def shardings_for_tree(mesh, tree, spec_fn):
    """Tree of DTensor placements of ``spec_fn(leaf.shape)``."""
    return _tree.tree_map(
        lambda leaf: placements(mesh, spec_fn(tuple(leaf.shape))), tree)


def local_shape(mesh, shape, spec: PartitionSpec) -> tuple:
    """One device's shard of a tensor of ``shape`` under ``spec``: each
    sharded dim divided by the product of its axes' sizes (`param_spec`
    and its siblings only shard dims their axes divide)."""
    sizes = _sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        if axes is not None:
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            dim //= math.prod(sizes[a] for a in names)
        out.append(dim)
    return tuple(out)


def local_bytes(mesh, leaf, spec: PartitionSpec) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``."""
    return math.prod(local_shape(mesh, tuple(leaf.shape), spec)) * \
        leaf.element_size()
