"""ODiMO-managed layer primitives shared by the CNNs and the façades
(``repro.models.managed`` counterpart).

A managed layer is a Conv / Dense layer whose weight passes through the
ODiMO mixing (mode ``"search"``), the discretized per-channel quantization
(``"finetune"``), or plain floats (``"fp"``).  Its output activations are
fake-quantized at the spec's worst-case bit-width in the quantized modes
(paper Sec. III-B).  Layers built without a spec stay in floats in every
mode.

Mode ``"deploy"`` executes a mapping: with a matmul backend installed
(``with matmul_backend(planned): ...``, `repro_torch.runtime.
PlannedBackend`) every layer its plan covers runs through the planned
kernel; layers the backend declines, or every layer when none is
installed, run with the discretized fake-quant weights.  The backend is
consulted in modes ``"fp"`` and ``"deploy"`` only.

Tensors are NHWC activations and HWIO conv weights, as in the JAX
package; the default conv path is ``F.conv2d`` over the NCHW view with
XLA's SAME padding made explicit (its odd pad after, at the bottom and
right, which ``padding="same"`` of torch does not give at stride 2).
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from repro_torch.core import odimo, quant
from repro_torch.core.cost_models import LayerGeometry
from repro_torch.core.odimo import ODiMOSpec
from repro_torch.models import _backend
from repro_torch.runtime.execute import _same_pads

Mode = Literal["fp", "search", "finetune", "deploy"]

# Re-exported context manager installing a pluggable matmul backend for every
# dense and conv primitive of the port.
matmul_backend = _backend.use


def _odimo_state(gen: torch.Generator, p: dict, spec: ODiMOSpec | None):
    if spec is not None:
        p["odimo"] = odimo.init_layer_state(gen, p["w"], spec)
        p["act_log_scale"] = torch.tensor(1.0, device=gen.device)
    return p


def init_conv(gen: torch.Generator, kh, kw, c_in, c_out,
              spec: ODiMOSpec | None = None, groups=1):
    """``{"w": (kh, kw, C_in/G, C_out) He-normal, "b": zeros}`` in float32,
    drawn from ``gen`` on its device; with a spec also the ``"odimo"``
    state (`odimo.init_layer_state`, drawn after the weight) and
    ``"act_log_scale"`` 1.0."""
    fan_in = kh * kw * (c_in // groups)
    w = torch.randn((kh, kw, c_in // groups, c_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    p = {"w": w * (2.0 / fan_in) ** 0.5,
         "b": torch.zeros(c_out, device=gen.device)}
    return _odimo_state(gen, p, spec)


def init_dense(gen: torch.Generator, c_in, c_out,
               spec: ODiMOSpec | None = None, bias: bool = True,
               scale: float | None = None):
    """``{"w": (C_in, C_out) N(0, scale^2), "b"?: zeros}`` in float32
    (default scale C_in**-0.5), drawn from ``gen`` on its device; a spec
    adds the ODiMO state as in `init_conv`."""
    s = scale if scale is not None else (1.0 / c_in) ** 0.5
    p = {"w": torch.randn((c_in, c_out), generator=gen, device=gen.device,
                          dtype=torch.float32) * s}
    if bias:
        p["b"] = torch.zeros(c_out, device=gen.device)
    return _odimo_state(gen, p, spec)


def _weight(p: dict, spec: ODiMOSpec | None, mode: Mode, tau):
    w = p["w"]
    if spec is None or mode == "fp" or "odimo" not in p:
        return w
    if mode == "search":
        return odimo.effective_weight(w, p["odimo"], spec, tau)
    return odimo.discretized_weight(w, p["odimo"], spec)


def _maybe_quant_act(x, p, spec: ODiMOSpec | None, mode: Mode):
    if spec is None or mode == "fp" or "act_log_scale" not in p:
        return x
    return quant.fake_quant_act(x, p["act_log_scale"], spec.act_bits)


def _backend_call(name, p, x, mode: Mode, **meta):
    """The installed backend's output for this call site, or None (no
    backend, a mode it does not serve, or a layer it declines)."""
    be = _backend.current()
    if be is None or mode not in ("fp", "deploy"):
        return None
    return be(name, p, x, **meta)


def _conv(p: dict, w: torch.Tensor, x: torch.Tensor, stride: int,
          padding: str, groups: int) -> torch.Tensor:
    """The default path: NHWC ``x`` conv HWIO ``w`` (+ ``p``'s bias)."""
    w = w.to(x.dtype)
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
                  tau=1.0, stride: int = 1, padding: str = "SAME",
                  groups: int = 1, name: str | None = None) -> torch.Tensor:
    """NHWC conv with an HWIO weight and no activation (residual
    branches).  ``name`` (the layer's params path) routes the call through
    the matmul backend, the geometry travelling as the ``conv`` meta; a
    backend returns the linear conv output, bias applied."""
    y = _backend_call(name, p, x, mode, conv={"stride": stride,
                                              "padding": padding,
                                              "groups": groups})
    if y is not None:
        return y
    return _conv(p, _weight(p, spec, mode, tau), x, stride, padding, groups)


def conv2d(p: dict, x: torch.Tensor, spec=None, mode: Mode = "fp",
           tau=1.0, stride: int = 1, padding: str = "SAME",
           groups: int = 1, name: str | None = None) -> torch.Tensor:
    """`conv2d_linear`, a ReLU (on the backend's output too), then the
    activation fake-quant of the quantized modes."""
    y = conv2d_linear(p, x, spec, mode, tau, stride, padding, groups, name)
    return _maybe_quant_act(torch.relu(y), p, spec, mode)


def dense(p: dict, x: torch.Tensor, spec=None, mode: Mode = "fp",
          tau=1.0, name: str | None = None) -> torch.Tensor:
    y = _backend_call(name, p, x, mode)
    if y is not None:
        return y  # planned kernel output, bias applied by the backend
    y = x @ _weight(p, spec, mode, tau).to(x.dtype)
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
