"""Vision model zoo built on the graph API.

The reference validates ResNet18-v2 / DenseNet-121 / Inception-v2 /
EfficientNet-Lite4 by importing downloaded ONNX files (reference
.github/workflows/build.yml:17-20, examples/python). This environment has no
network, so the same architectures are *constructed* through GraphHandler —
which exercises the identical graph/op/executor surface the ONNX path uses —
and parity-tested against hand-built torch oracles.

All builders take a params dict {name: np.ndarray} (random-initialized via
``init_*_params``) so tests can copy identical weights into the oracle.

Copy of infinitensor_tpu/models/vision.py over this package's
GraphHandler: the same numpy params build the same graph, which runs on
the card (GraphExecutor's captured CUDA graph) unless the handler's
runtime is the CPU's (``h.runtime = cpu_runtime()`` before ``h.run``).
"""

from __future__ import annotations

import numpy as np

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.handler import GraphHandler


# ---------------------------------------------------------------------------
# ResNet-18 v2 (pre-activation; reference model set)
# ---------------------------------------------------------------------------

def init_resnet18_params(rng, num_classes: int = 1000) -> dict:
    p = {}

    def conv(name, cout, cin, k):
        p[name + ".w"] = (rng.standard_normal((cout, cin, k, k))
                         * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    def bn(name, c):
        p[name + ".scale"] = np.abs(rng.standard_normal(c)).astype(np.float32) * 0.5 + 0.5
        p[name + ".bias"] = rng.standard_normal(c).astype(np.float32) * 0.1
        p[name + ".mean"] = rng.standard_normal(c).astype(np.float32) * 0.1
        p[name + ".var"] = (np.abs(rng.standard_normal(c)) + 0.9).astype(np.float32)

    conv("stem", 64, 3, 7)
    bn("stem.bn", 64)
    chans = [64, 64, 128, 256, 512]
    for stage in range(4):
        cin, cout = chans[stage], chans[stage + 1]
        for blk in range(2):
            base = f"s{stage}.b{blk}"
            c_in = cin if blk == 0 else cout
            bn(base + ".bn1", c_in)
            conv(base + ".conv1", cout, c_in, 3)
            bn(base + ".bn2", cout)
            conv(base + ".conv2", cout, cout, 3)
            if blk == 0 and (cin != cout or stage > 0):
                conv(base + ".down", cout, cin, 1)
    bn("final.bn", 512)
    p["fc.w"] = (rng.standard_normal((512, num_classes))
                 * np.sqrt(1.0 / 512)).astype(np.float32)
    p["fc.b"] = np.zeros(num_classes, np.float32)
    return p


def build_resnet18(params: dict, batch: int = 1, image: int = 224,
                   num_classes: int = 1000) -> GraphHandler:
    h = GraphHandler(name="resnet18v2")
    w = {k: h.weight(v, name=k) for k, v in params.items()}
    x = h.input((batch, 3, image, image), name="input")

    def bnorm(t, name):
        return h.batch_normalization(t, w[name + ".scale"], w[name + ".bias"],
                                     w[name + ".mean"], w[name + ".var"])

    t = h.conv(x, w["stem.w"], pads=(3, 3), strides=(2, 2))
    t = h.relu(bnorm(t, "stem.bn"))
    t = h.max_pool(t, kernel=(3, 3), strides=(2, 2), pads=(1, 1))

    chans = [64, 64, 128, 256, 512]
    for stage in range(4):
        cin, cout = chans[stage], chans[stage + 1]
        stride = 1 if stage == 0 else 2
        for blk in range(2):
            base = f"s{stage}.b{blk}"
            s = stride if blk == 0 else 1
            pre = h.relu(bnorm(t, base + ".bn1"))
            if blk == 0 and (cin != cout or stage > 0):
                shortcut = h.conv(pre, w[base + ".down.w"], strides=(s, s))
            else:
                shortcut = t
            u = h.conv(pre, w[base + ".conv1.w"], pads=(1, 1), strides=(s, s))
            u = h.relu(bnorm(u, base + ".bn2"))
            u = h.conv(u, w[base + ".conv2.w"], pads=(1, 1))
            t = h.add(shortcut, u)

    t = h.relu(bnorm(t, "final.bn"))
    t = h.global_avg_pool(t)
    t = h.flatten(t, axis=1)
    t = h.add(h.matmul(t, w["fc.w"]), w["fc.b"])
    h.graph.infer_output_roles()
    return h


# ---------------------------------------------------------------------------
# DenseNet (reduced configurable variant of DenseNet-121's block structure)
# ---------------------------------------------------------------------------

def init_densenet_params(rng, growth=32, block_layers=(6, 12, 24, 16),
                         num_classes=1000, init_c=64):
    p = {}

    def conv(name, cout, cin, k):
        p[name] = (rng.standard_normal((cout, cin, k, k))
                   * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    def bn(name, c):
        p[name + ".scale"] = np.ones(c, np.float32)
        p[name + ".bias"] = np.zeros(c, np.float32)
        p[name + ".mean"] = rng.standard_normal(c).astype(np.float32) * 0.05
        p[name + ".var"] = np.ones(c, np.float32)

    conv("stem", init_c, 3, 7)
    bn("stem.bn", init_c)
    c = init_c
    for bi, n_layers in enumerate(block_layers):
        for li in range(n_layers):
            base = f"d{bi}.l{li}"
            bn(base + ".bn1", c)
            conv(base + ".conv1", 4 * growth, c, 1)
            bn(base + ".bn2", 4 * growth)
            conv(base + ".conv2", growth, 4 * growth, 3)
            c += growth
        if bi != len(block_layers) - 1:
            bn(f"t{bi}.bn", c)
            conv(f"t{bi}.conv", c // 2, c, 1)
            c //= 2
    bn("final.bn", c)
    p["fc.w"] = (rng.standard_normal((c, num_classes))
                 * np.sqrt(1.0 / c)).astype(np.float32)
    p["fc.b"] = np.zeros(num_classes, np.float32)
    return p


def build_densenet(params: dict, batch=1, image=224, growth=32,
                   block_layers=(6, 12, 24, 16), num_classes=1000,
                   init_c=64) -> GraphHandler:
    h = GraphHandler(name="densenet")
    w = {k: h.weight(v, name=k) for k, v in params.items()}
    x = h.input((batch, 3, image, image), name="input")

    def bnr(t, name):
        return h.relu(h.batch_normalization(
            t, w[name + ".scale"], w[name + ".bias"], w[name + ".mean"],
            w[name + ".var"]))

    t = h.conv(x, w["stem"], pads=(3, 3), strides=(2, 2))
    t = bnr(t, "stem.bn")
    t = h.max_pool(t, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
    for bi, n_layers in enumerate(block_layers):
        for li in range(n_layers):
            base = f"d{bi}.l{li}"
            u = bnr(t, base + ".bn1")
            u = h.conv(u, w[base + ".conv1"])
            u = bnr(u, base + ".bn2")
            u = h.conv(u, w[base + ".conv2"], pads=(1, 1))
            t = h.concat([t, u], axis=1)
        if bi != len(block_layers) - 1:
            t = bnr(t, f"t{bi}.bn")
            t = h.conv(t, w[f"t{bi}.conv"])
            t = h.avg_pool(t, kernel=(2, 2), strides=(2, 2))
    t = bnr(t, "final.bn")
    t = h.global_avg_pool(t)
    t = h.flatten(t, axis=1)
    h.add(h.matmul(t, w["fc.w"]), w["fc.b"])
    h.graph.infer_output_roles()
    return h


# ---------------------------------------------------------------------------
# Inception-style block (GoogLeNet/Inception-v2's characteristic topology)
# ---------------------------------------------------------------------------

def init_inception_block_params(rng, cin, b1, b3r, b3, b5r, b5, bp):
    p = {}

    def conv(name, cout, cin_, k):
        p[name] = (rng.standard_normal((cout, cin_, k, k))
                   * np.sqrt(2.0 / (cin_ * k * k))).astype(np.float32)

    conv("b1", b1, cin, 1)
    conv("b3r", b3r, cin, 1)
    conv("b3", b3, b3r, 3)
    conv("b5r", b5r, cin, 1)
    conv("b5a", b5, b5r, 3)
    conv("b5b", b5, b5, 3)
    conv("bp", bp, cin, 1)
    return p


def build_inception_block(h: GraphHandler, x, w: dict):
    p1 = h.relu(h.conv(x, w["b1"]))
    p3 = h.relu(h.conv(h.relu(h.conv(x, w["b3r"])), w["b3"], pads=(1, 1)))
    p5 = h.relu(h.conv(x, w["b5r"]))
    p5 = h.relu(h.conv(p5, w["b5a"], pads=(1, 1)))
    p5 = h.relu(h.conv(p5, w["b5b"], pads=(1, 1)))
    pp = h.relu(h.conv(h.max_pool(x, kernel=(3, 3), strides=(1, 1),
                                  pads=(1, 1)), w["bp"]))
    return h.concat([p1, p3, p5, pp], axis=1)


# ---------------------------------------------------------------------------
# EfficientNet-style MBConv block (EfficientNet-Lite4's building block)
# ---------------------------------------------------------------------------

def init_mbconv_params(rng, cin, cout, expand=6, k=3):
    mid = cin * expand
    p = {}
    p["expand.w"] = (rng.standard_normal((mid, cin, 1, 1))
                     * np.sqrt(2.0 / cin)).astype(np.float32)
    p["dw.w"] = (rng.standard_normal((mid, 1, k, k))
                 * np.sqrt(2.0 / (k * k))).astype(np.float32)
    p["proj.w"] = (rng.standard_normal((cout, mid, 1, 1))
                   * np.sqrt(2.0 / mid)).astype(np.float32)
    for name, c in [("expand.bn", mid), ("dw.bn", mid), ("proj.bn", cout)]:
        p[name + ".scale"] = np.ones(c, np.float32)
        p[name + ".bias"] = np.zeros(c, np.float32)
        p[name + ".mean"] = np.zeros(c, np.float32)
        p[name + ".var"] = np.ones(c, np.float32)
    return p


def build_mbconv(h: GraphHandler, x, w: dict, stride=1):
    cin = x.shape[1]
    mid = w["expand.w"].shape[0]

    def bn(t, name):
        return h.batch_normalization(t, w[name + ".scale"], w[name + ".bias"],
                                     w[name + ".mean"], w[name + ".var"])

    t = h.relu(bn(h.conv(x, w["expand.w"]), "expand.bn"))  # relu6 in lite
    k = w["dw.w"].shape[2]
    t = h.relu(bn(h.conv(t, w["dw.w"], pads=(k // 2, k // 2),
                         strides=(stride, stride), group=mid), "dw.bn"))
    t = bn(h.conv(t, w["proj.w"]), "proj.bn")
    if stride == 1 and x.shape[1] == t.shape[1]:
        t = h.add(x, t)
    return t


# ---------------------------------------------------------------------------
# Inception-v2 (BN-Inception): full model from the factorized blocks above
# (5x5 branch as two 3x3s IS the v2 change). Channel table follows the
# BN-Inception paper's 3a-5b progression; reference CI imports this model
# as ONNX (reference .github/workflows/build.yml:77-88).
# ---------------------------------------------------------------------------

_INCEPTION_V2_TABLE = [
    ("3a", 64, 64, 64, 64, 96, 32),
    ("3b", 64, 64, 96, 64, 96, 64),
    "pool",
    ("4a", 224, 64, 96, 96, 128, 128),
    ("4b", 192, 96, 128, 96, 128, 128),
    ("4c", 160, 128, 160, 128, 160, 96),
    ("4d", 96, 128, 192, 160, 192, 96),
    "pool",
    ("5a", 352, 192, 320, 160, 224, 128),
    ("5b", 352, 192, 320, 192, 224, 128),
]


def init_inception_v2_params(rng, num_classes: int = 1000) -> dict:
    p = {}

    def conv(name, cout, cin, k):
        p[name] = (rng.standard_normal((cout, cin, k, k))
                   * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    conv("stem.c7", 64, 3, 7)
    conv("stem.c1", 64, 64, 1)
    conv("stem.c3", 192, 64, 3)
    cin = 192
    for row in _INCEPTION_V2_TABLE:
        if row == "pool":
            continue
        name, b1, b3r, b3, b5r, b5, bp = row
        blk = init_inception_block_params(rng, cin, b1, b3r, b3, b5r, b5, bp)
        for k, v in blk.items():
            p[f"{name}.{k}"] = v
        cin = b1 + b3 + b5 + bp
    p["fc.w"] = (rng.standard_normal((cin, num_classes))
                 * np.sqrt(1.0 / cin)).astype(np.float32)
    p["fc.b"] = np.zeros(num_classes, np.float32)
    return p


def build_inception_v2(params: dict, batch: int = 1, image: int = 224,
                       num_classes: int = 1000) -> GraphHandler:
    h = GraphHandler(name="inception_v2")
    w = {k: h.weight(v, name=k) for k, v in params.items()}
    x = h.input((batch, 3, image, image), name="input")

    t = h.relu(h.conv(x, w["stem.c7"], pads=(3, 3), strides=(2, 2)))
    t = h.max_pool(t, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
    t = h.relu(h.conv(t, w["stem.c1"]))
    t = h.relu(h.conv(t, w["stem.c3"], pads=(1, 1)))
    t = h.max_pool(t, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
    for row in _INCEPTION_V2_TABLE:
        if row == "pool":
            t = h.max_pool(t, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
            continue
        name = row[0]
        sub = {k.split(".", 1)[1]: v for k, v in w.items()
               if k.startswith(name + ".")}
        t = build_inception_block(h, t, sub)
    t = h.global_avg_pool(t)
    t = h.flatten(t, axis=1)
    t = h.add(h.matmul(t, w["fc.w"]), w["fc.b"])
    h.graph.infer_output_roles()
    return h


# ---------------------------------------------------------------------------
# EfficientNet-Lite4: full model from the MBConv block above. Stage table =
# the lite4 scaling of the B0 table (width x1.4 rounded to 8, depth x1.8
# ceil; lite fixes stem=32/head=1280, drops squeeze-excite, and pins the
# FIRST and LAST stage at 1 repeat — depth scaling skips them, matching
# the official lite4 checkpoints). Structural variant: ReLU in place of
# ReLU6, and stage 1 keeps a (1x) expand conv.
# ---------------------------------------------------------------------------

_LITE4_STAGES = [  # (expand, cout, repeats, stride, kernel)
    (1, 24, 1, 1, 3),
    (6, 32, 4, 2, 3),
    (6, 56, 4, 2, 5),
    (6, 112, 6, 2, 3),
    (6, 160, 6, 1, 5),
    (6, 272, 8, 2, 5),
    (6, 448, 1, 1, 3),
]


def init_efficientnet_lite4_params(rng, num_classes: int = 1000) -> dict:
    p = {}
    p["stem.w"] = (rng.standard_normal((32, 3, 3, 3))
                   * np.sqrt(2.0 / 27)).astype(np.float32)
    for name, c in [("stem.bn", 32), ("head.bn", 1280)]:
        p[name + ".scale"] = np.ones(c, np.float32)
        p[name + ".bias"] = np.zeros(c, np.float32)
        p[name + ".mean"] = np.zeros(c, np.float32)
        p[name + ".var"] = np.ones(c, np.float32)
    cin = 32
    for si, (expand, cout, repeats, _stride, k) in enumerate(_LITE4_STAGES):
        for bi in range(repeats):
            blk = init_mbconv_params(rng, cin, cout, expand=expand, k=k)
            for kk, v in blk.items():
                p[f"s{si}.b{bi}.{kk}"] = v
            cin = cout
    p["head.w"] = (rng.standard_normal((1280, cin, 1, 1))
                   * np.sqrt(2.0 / cin)).astype(np.float32)
    p["fc.w"] = (rng.standard_normal((1280, num_classes))
                 * np.sqrt(1.0 / 1280)).astype(np.float32)
    p["fc.b"] = np.zeros(num_classes, np.float32)
    return p


def build_efficientnet_lite4(params: dict, batch: int = 1, image: int = 224,
                             num_classes: int = 1000) -> GraphHandler:
    h = GraphHandler(name="efficientnet_lite4")
    w = {k: h.weight(v, name=k) for k, v in params.items()}
    x = h.input((batch, 3, image, image), name="input")

    def bn(t, name):
        return h.batch_normalization(t, w[name + ".scale"], w[name + ".bias"],
                                     w[name + ".mean"], w[name + ".var"])

    t = h.relu(bn(h.conv(x, w["stem.w"], pads=(1, 1), strides=(2, 2)),
                  "stem.bn"))
    for si, (_expand, _cout, repeats, stride, _k) in enumerate(_LITE4_STAGES):
        for bi in range(repeats):
            sub = {kk.split(".", 2)[2]: v for kk, v in w.items()
                   if kk.startswith(f"s{si}.b{bi}.")}
            t = build_mbconv(h, t, sub, stride=stride if bi == 0 else 1)
    t = h.relu(bn(h.conv(t, w["head.w"]), "head.bn"))
    t = h.global_avg_pool(t)
    t = h.flatten(t, axis=1)
    t = h.add(h.matmul(t, w["fc.w"]), w["fc.b"])
    h.graph.infer_output_roles()
    return h
