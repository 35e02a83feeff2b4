"""The paper's CNN benchmarks (``repro.models.cnn`` counterpart): ResNet20
(CIFAR-10), ResNet18 (Tiny-ImageNet) and MobileNetV1-0.25x (VWW), Sec.
IV-A.

BatchNorm is folded into the convolutions (DIANA has no BN hardware), so
layers are conv + bias.  Each model exposes, as in the JAX package:

    init(gen, cfg, spec=None)                -> params (float32, gen's
                                                device; with a spec each
                                                layer carries its ODiMO
                                                state)
    apply(params, x, cfg, spec, mode, tau)   -> logits; x is NHWC
    plan(cfg)                                -> [(name, LayerGeometry,
                                                searchable)]

Layer names are params paths (``"stem"``, ``"blocks/3/c1"``, ``"head"``),
which a mapping artifact names and a planned backend binds.  Depthwise
convs of MobileNetV1 are not searchable: they stay on the digital domain
(paper Sec. IV-A).  JAX parameters carry across with
`repro_torch.models.transformer.params_from_jax`, which takes any nested
dict / list tree.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.cost_models import LayerGeometry
from repro_torch.core.odimo import ODiMOSpec
from repro_torch.models import managed as mg


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    img_hw: Tuple[int, int]
    in_ch: int
    n_classes: int
    width_mult: float = 1.0


RESNET20_CFG = CNNConfig("resnet20", (32, 32), 3, 10)
RESNET18_CFG = CNNConfig("resnet18", (64, 64), 3, 200)
RESNET18_SMALL = CNNConfig("resnet18_small", (32, 32), 3, 50)
MBV1_CFG = CNNConfig("mobilenetv1_025", (96, 96), 3, 2, width_mult=0.25)

# reduced configs for the CPU tests
RESNET20_TINY = CNNConfig("resnet20_tiny", (16, 16), 3, 10)
MBV1_TINY = CNNConfig("mobilenetv1_tiny", (32, 32), 3, 2, width_mult=0.25)

CONFIGS = {c.name: c for c in (RESNET20_CFG, RESNET18_CFG, RESNET18_SMALL,
                               MBV1_CFG, RESNET20_TINY, MBV1_TINY)}


def get_config(name: str) -> CNNConfig:
    """Named CNN config (the ``cnn:<name>`` arch of the launch drivers)."""
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown CNN config {name!r} "
                         f"(known: {sorted(CONFIGS)})") from None


# --------------------------------------------------------------------------
# ResNet (BN-folded basic blocks)
# --------------------------------------------------------------------------

def _resnet_stages(name: str):
    """([(width, blocks, stride)], stem width)."""
    if "20" in name:
        return [(16, 3, 1), (32, 3, 2), (64, 3, 2)], 16
    return [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)], 64


def resnet_init(gen: torch.Generator, cfg: CNNConfig,
                spec: ODiMOSpec | None = None):
    stages, stem_w = _resnet_stages(cfg.name)
    p = {"stem": mg.init_conv(gen, 3, 3, cfg.in_ch, stem_w, spec)}
    blocks = []
    c_prev = stem_w
    for (w, n, s) in stages:
        for b in range(n):
            stride = s if b == 0 else 1
            blk = {"c1": mg.init_conv(gen, 3, 3, c_prev, w, spec),
                   "c2": mg.init_conv(gen, 3, 3, w, w, spec)}
            if stride != 1 or c_prev != w:
                blk["proj"] = mg.init_conv(gen, 1, 1, c_prev, w, spec)
            blocks.append(blk)
            c_prev = w
    p["blocks"] = blocks
    p["head"] = mg.init_dense(gen, c_prev, cfg.n_classes, spec)
    return p


def resnet_apply(p, x, cfg: CNNConfig, spec=None, mode="fp", tau=1.0):
    stages, _ = _resnet_stages(cfg.name)
    x = mg.conv2d(p["stem"], x, spec, mode, tau, name="stem")
    bi = 0
    for (w, n, s) in stages:
        for b in range(n):
            stride = s if b == 0 else 1
            blk = p["blocks"][bi]
            h = mg.conv2d(blk["c1"], x, spec, mode, tau, stride=stride,
                          name=f"blocks/{bi}/c1")
            h = mg.conv2d_linear(blk["c2"], h, spec, mode, tau,
                                 name=f"blocks/{bi}/c2")
            sc = x
            if "proj" in blk:
                sc = mg.conv2d_linear(blk["proj"], x, spec, mode, tau,
                                      stride=stride,
                                      name=f"blocks/{bi}/proj")
            x = torch.relu(h + sc)
            x = mg._maybe_quant_act(x, blk["c2"], spec, mode)
            bi += 1
    x = torch.mean(x, dim=(1, 2))
    return mg.dense(p["head"], x, spec, mode, tau, name="head")


def resnet_plan(cfg: CNNConfig) -> List[Tuple[str, LayerGeometry, bool]]:
    stages, stem_w = _resnet_stages(cfg.name)
    hw = cfg.img_hw
    plan = [("stem", mg.conv_geometry(3, 3, cfg.in_ch, stem_w, hw), True)]
    c_prev = stem_w
    bi = 0
    for (w, n, s) in stages:
        for b in range(n):
            stride = s if b == 0 else 1
            hw = (hw[0] // stride, hw[1] // stride)
            plan.append((f"blocks/{bi}/c1",
                         mg.conv_geometry(3, 3, c_prev, w, hw), True))
            plan.append((f"blocks/{bi}/c2",
                         mg.conv_geometry(3, 3, w, w, hw), True))
            if stride != 1 or c_prev != w:
                plan.append((f"blocks/{bi}/proj",
                             mg.conv_geometry(1, 1, c_prev, w, hw), True))
            c_prev = w
            bi += 1
    plan.append(("head", mg.dense_geometry(c_prev, cfg.n_classes), True))
    return plan


# --------------------------------------------------------------------------
# MobileNetV1 (depthwise separable; depthwise convs not searchable)
# --------------------------------------------------------------------------

MBV1_LAYERS = [  # (stride, c_out at 1.0x) of the 13 separable blocks
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
]


def _mb_w(c, mult):
    """Width at multiplier ``mult``, at least 8."""
    return max(8, int(c * mult))


def mbv1_init(gen: torch.Generator, cfg: CNNConfig,
              spec: ODiMOSpec | None = None):
    c0 = _mb_w(32, cfg.width_mult)
    p = {"stem": mg.init_conv(gen, 3, 3, cfg.in_ch, c0, spec)}
    blocks = []
    c_prev = c0
    for (s, c) in MBV1_LAYERS:
        cw = _mb_w(c, cfg.width_mult)
        blocks.append({
            "dw": mg.init_conv(gen, 3, 3, c_prev, c_prev, spec,
                               groups=c_prev),
            "pw": mg.init_conv(gen, 1, 1, c_prev, cw, spec),
        })
        c_prev = cw
    p["blocks"] = blocks
    p["head"] = mg.init_dense(gen, c_prev, cfg.n_classes, spec)
    return p


def mbv1_apply(p, x, cfg: CNNConfig, spec=None, mode="fp", tau=1.0):
    x = mg.conv2d(p["stem"], x, spec, mode, tau, stride=2, name="stem")
    c_prev = _mb_w(32, cfg.width_mult)
    for i, (blk, (s, c)) in enumerate(zip(p["blocks"], MBV1_LAYERS)):
        x = mg.conv2d(blk["dw"], x, spec, mode, tau, stride=s, groups=c_prev,
                      name=f"blocks/{i}/dw")
        x = mg.conv2d(blk["pw"], x, spec, mode, tau, name=f"blocks/{i}/pw")
        c_prev = _mb_w(c, cfg.width_mult)
    x = torch.mean(x, dim=(1, 2))
    return mg.dense(p["head"], x, spec, mode, tau, name="head")


def mbv1_plan(cfg: CNNConfig) -> List[Tuple[str, LayerGeometry, bool]]:
    hw = (cfg.img_hw[0] // 2, cfg.img_hw[1] // 2)
    c0 = _mb_w(32, cfg.width_mult)
    plan = [("stem", mg.conv_geometry(3, 3, cfg.in_ch, c0, hw), True)]
    c_prev = c0
    for i, (s, c) in enumerate(MBV1_LAYERS):
        hw = (hw[0] // s, hw[1] // s)
        cw = _mb_w(c, cfg.width_mult)
        plan.append((f"blocks/{i}/dw",
                     mg.conv_geometry(3, 3, c_prev, c_prev, hw,
                                      groups=c_prev), False))
        plan.append((f"blocks/{i}/pw",
                     mg.conv_geometry(1, 1, c_prev, cw, hw), True))
        c_prev = cw
    plan.append(("head", mg.dense_geometry(c_prev, cfg.n_classes), True))
    return plan


# --------------------------------------------------------------------------
# Uniform façade
# --------------------------------------------------------------------------

def get_model(cfg: CNNConfig):
    """(init, apply, plan) of ``cfg``'s family."""
    if cfg.name.startswith("resnet"):
        return resnet_init, resnet_apply, resnet_plan
    if cfg.name.startswith("mobilenet"):
        return mbv1_init, mbv1_apply, mbv1_plan
    raise ValueError(cfg.name)


def get_by_path(params, path: str):
    return mg.get_by_path(params, path)


def plan_hints(cfg: CNNConfig):
    """``{name: (LayerGeometry, searchable)}`` of ``cfg``'s plan: the
    ``plan_hints`` of `repro_torch.launch.train.emit_static_mapping`."""
    _, _, plan_fn = get_model(cfg)
    return {n: (g, s) for (n, g, s) in plan_fn(cfg)}


def managed_layer_dicts(params, cfg: CNNConfig):
    """Param dicts of all managed layers, in plan order."""
    _, _, plan_fn = get_model(cfg)
    return [get_by_path(params, name) for (name, _, _) in plan_fn(cfg)]
