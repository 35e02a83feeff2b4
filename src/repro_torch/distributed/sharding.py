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
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

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
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _ACTIVATION_SPECS[kind](_AXES["dp"], _AXES["tp"])
    if x.ndim < len(spec):
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    mesh = x.device_mesh
    spec = tuple(a if _divides(mesh, a, d) and d > 1 else None
                 for a, d in zip(spec, x.shape))
    return x.redistribute(mesh, placements(mesh, P(*spec)))


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
    from torch.distributed.tensor import Replicate, Shard
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


def local_bytes(mesh, leaf, spec: PartitionSpec) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec`` (each
    sharded dim divided by the product of its axes' sizes; `param_spec`
    and its siblings only shard dims their axes divide)."""
    sizes = _sizes(mesh)
    n = 1
    for d, dim in enumerate(leaf.shape):
        axes = spec[d] if d < len(spec) else None
        if axes is not None:
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            dim //= math.prod(sizes[a] for a in names)
        n *= dim
    return n * leaf.element_size()
