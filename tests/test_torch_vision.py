"""The port's vision builders (models/vision.py) against the JAX package's,
on the CPU: the same seeded numpy parameters (both init_* functions give
them bit for bit), the same graph op for op, both executors on the same
image. Every builder at a small image: ResNet-18-v2 at 64, DenseNet (2 + 2
layers, growth 8) and DenseNet-121's table at 32, the Inception block and
the MBConv block at 16, Inception-v2 and EfficientNet-Lite4 (full tables)
at 64. Logits within
2e-3 of max|logit| (f32 convolutions summed in another order, as
tests/test_torch_graph.py's convolution cases).
"""

import numpy as np
import pytest

from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.models import vision as jv

from infinitensor_tpu_torch.core.handler import GraphHandler as THandler
from infinitensor_tpu_torch.models import vision as tv
from infinitensor_tpu_torch.runtime.runtime import cpu_runtime

TOL = 2e-3


def _resnet(v, h, seed):
    p = v.init_resnet18_params(np.random.default_rng(seed), num_classes=16)
    return p, v.build_resnet18(p, batch=1, image=64, num_classes=16), 64


def _densenet(v, h, seed):
    kw = dict(growth=8, block_layers=(2, 2), num_classes=10, init_c=16)
    p = v.init_densenet_params(np.random.default_rng(seed), **kw)
    return p, v.build_densenet(p, batch=2, image=32, **kw), 32


def _densenet121(v, h, seed):
    p = v.init_densenet_params(np.random.default_rng(seed), num_classes=8)
    return p, v.build_densenet(p, batch=1, image=32, num_classes=8), 32


def _inception_block(v, h, seed):
    p = v.init_inception_block_params(np.random.default_rng(seed), cin=16,
                                      b1=8, b3r=8, b3=12, b5r=4, b5=6, bp=6)
    g = h()
    x = g.input((1, 16, 16, 16), name="input")
    v.build_inception_block(g, x, {k: g.weight(a, name=k)
                                   for k, a in p.items()})
    g.graph.infer_output_roles()
    return p, g, 16


def _mbconv(v, h, seed):
    p = v.init_mbconv_params(np.random.default_rng(seed), cin=8, cout=8,
                             expand=4, k=3)
    g = h()
    x = g.input((2, 8, 16, 16), name="input")
    w = {k: g.weight(a, name=k) for k, a in p.items()}
    v.build_mbconv(g, v.build_mbconv(g, x, w, stride=1), w, stride=2)
    g.graph.infer_output_roles()
    return p, g, 16


def _inception_v2(v, h, seed):
    p = v.init_inception_v2_params(np.random.default_rng(seed),
                                   num_classes=8)
    return p, v.build_inception_v2(p, batch=1, image=64, num_classes=8), 64


def _lite4(v, h, seed):
    p = v.init_efficientnet_lite4_params(np.random.default_rng(seed),
                                         num_classes=8)
    return p, v.build_efficientnet_lite4(p, batch=1, image=64,
                                         num_classes=8), 64


BUILDERS = {"resnet18": _resnet, "densenet": _densenet,
            "densenet121": _densenet121,
            "inception_block": _inception_block, "mbconv": _mbconv,
            "inception_v2": _inception_v2,
            "efficientnet_lite4": _lite4}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_against_jax(name):
    pj, hj, image = BUILDERS[name](jv, JHandler, 5)
    pt, ht, _ = BUILDERS[name](tv, THandler, 5)
    assert pj.keys() == pt.keys()
    assert all(np.array_equal(pj[k], pt[k]) for k in pj)
    assert [(op.op_type, op.attrs) for op in hj.graph.operators] == \
        [(op.op_type, op.attrs) for op in ht.graph.operators]
    ht.runtime = cpu_runtime()
    x = hj.graph.inputs()[0]
    img = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    want = list(hj.run({"input": img}, return_numpy=True).values())
    got = list(ht.run({"input": img}, return_numpy=True).values())
    assert len(want) == len(got) == 1
    w, g = np.asarray(want[0]), got[0]
    assert g.shape == w.shape and g.dtype == np.float32
    assert np.isfinite(g).all()
    err, ref = np.abs(g - w).max(), np.abs(w).max()
    assert err <= TOL * ref, (err, ref)
