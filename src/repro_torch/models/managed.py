"""ODiMO-managed layer primitives shared by the CNNs (``repro.models.
managed`` counterpart).

A managed layer is a Conv / Dense layer whose weight the ODiMO search
mixes, discretizes or leaves in floats.  The port serves: mode ``"fp"``
with no spec, where a matmul backend installed with ``with
matmul_backend(planned): ...`` (`repro_torch.runtime.PlannedBackend`) runs
every layer its plan covers through the planned kernel, and the default
path runs the rest.  An ODiMO spec and the modes ``"search"``,
``"finetune"`` and ``"deploy"`` wait for the search side (`SEARCH_ITEM`).

Tensors are NHWC activations and HWIO conv weights, as in the JAX
package; the default conv path is ``F.conv2d`` over the NCHW view with
XLA's SAME padding made explicit (its odd pad after, at the bottom and
right, which ``padding="same"`` of torch does not give at stride 2).
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from repro_torch.core.cost_models import LayerGeometry
from repro_torch.models import _backend
from repro_torch.runtime.execute import _same_pads

Mode = Literal["fp", "search", "finetune", "deploy"]

#: the roadmap item that brings the ODiMO search (specs and the other modes)
SEARCH_ITEM = "ROADMAP.md Queue 1 item 7 (the search side)"

# Re-exported context manager installing a pluggable matmul backend for every
# dense and conv primitive of the port.
matmul_backend = _backend.use


def _serving_only(spec, mode: str):
    if spec is not None or mode != "fp":
        raise NotImplementedError(
            f"managed layers with an ODiMO spec or mode {mode!r} wait for "
            f"{SEARCH_ITEM}")


def init_conv(gen: torch.Generator, kh, kw, c_in, c_out, spec=None,
              groups=1):
    """``{"w": (kh, kw, C_in/G, C_out) He-normal, "b": zeros}`` in float32,
    drawn from ``gen`` on its device."""
    _serving_only(spec, "fp")
    fan_in = kh * kw * (c_in // groups)
    w = torch.randn((kh, kw, c_in // groups, c_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return {"w": w * (2.0 / fan_in) ** 0.5,
            "b": torch.zeros(c_out, device=gen.device)}


def init_dense(gen: torch.Generator, c_in, c_out, spec=None,
               bias: bool = True, scale: float | None = None):
    """``{"w": (C_in, C_out) N(0, scale^2), "b"?: zeros}`` in float32
    (default scale C_in**-0.5), drawn from ``gen`` on its device."""
    _serving_only(spec, "fp")
    s = scale if scale is not None else (1.0 / c_in) ** 0.5
    p = {"w": torch.randn((c_in, c_out), generator=gen, device=gen.device,
                          dtype=torch.float32) * s}
    if bias:
        p["b"] = torch.zeros(c_out, device=gen.device)
    return p


def _conv(p: dict, x: torch.Tensor, stride: int, padding: str,
          groups: int) -> torch.Tensor:
    """The default path: NHWC ``x`` conv HWIO ``p["w"]`` (+ bias)."""
    w = p["w"].to(x.dtype)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        _, pt, pb = _same_pads(int(x.shape[1]), kh, stride)
        _, pl, pr = _same_pads(int(x.shape[2]), kw, stride)
        xc = F.pad(xc, (pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"unsupported conv padding {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv2d_linear(p: dict, x: torch.Tensor, spec=None, mode: Mode = "fp",
                  tau: float = 1.0, stride: int = 1, padding: str = "SAME",
                  groups: int = 1, name: str | None = None) -> torch.Tensor:
    """NHWC conv with an HWIO weight and no activation (residual
    branches).  ``name`` (the layer's params path) routes the call through
    the matmul backend, the geometry travelling as the ``conv`` meta; a
    backend returns the linear conv output, bias applied."""
    _serving_only(spec, mode)
    be = _backend.current()
    if be is not None:
        y = be(name, p, x, conv={"stride": stride, "padding": padding,
                                 "groups": groups})
        if y is not None:
            return y
    return _conv(p, x, stride, padding, groups)


def conv2d(p: dict, x: torch.Tensor, spec=None, mode: Mode = "fp",
           tau: float = 1.0, stride: int = 1, padding: str = "SAME",
           groups: int = 1, name: str | None = None) -> torch.Tensor:
    """`conv2d_linear` followed by a ReLU (on the backend's output too)."""
    return torch.relu(conv2d_linear(p, x, spec, mode, tau, stride, padding,
                                    groups, name))


def dense(p: dict, x: torch.Tensor, spec=None, mode: Mode = "fp",
          tau: float = 1.0, name: str | None = None) -> torch.Tensor:
    _serving_only(spec, mode)
    be = _backend.current()
    if be is not None:
        y = be(name, p, x)
        if y is not None:
            return y  # planned kernel output, bias applied by the backend
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def get_by_path(params, path: str):
    """Resolve ``"a/0/b"`` into ``params["a"][0]["b"]`` (plan-name lookup)."""
    node = params
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) \
            else node[part]
    return node


def conv_geometry(kh, kw, c_in, c_out, out_hw, groups=1) -> LayerGeometry:
    return LayerGeometry(c_in=c_in, c_out=c_out, fx=kw, fy=kh,
                         ox=out_hw[1], oy=out_hw[0], groups=groups)


def dense_geometry(c_in, c_out) -> LayerGeometry:
    return LayerGeometry(c_in=c_in, c_out=c_out)
