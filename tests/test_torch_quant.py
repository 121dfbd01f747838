"""The port's weight-only quantization writes the JAX package's bytes.

Seeded numpy weights go through infinitensor_tpu.quant.weight_only and
infinitensor_tpu_torch.quant.weight_only; packed bytes and scales must be
equal bit for bit. The clip="mse" search compares per-group squared
errors whose sums may be taken in another order; on these seeds no
near-tie flips a group's pick (if one ever did, one scale and its group's
codes would differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.quant import weight_only as jw
from infinitensor_tpu_torch.quant import weight_only as tw


def _both(din, dout, seed=0, **kw):
    w = np.random.default_rng(seed).standard_normal((din, dout)).astype(
        np.float32)
    return (jw.quantize_weight(jnp.asarray(w), **kw),
            tw.quantize_weight(torch.from_numpy(w), **kw))


def _same(qj, qt):
    assert (qj.bits, qj.group_size, qj.out_logical) == \
        (qt.bits, qt.group_size, qt.out_logical)
    np.testing.assert_array_equal(np.asarray(qj.qweight), qt.qweight.numpy())
    np.testing.assert_array_equal(np.asarray(qj.scales), qt.scales.numpy())
    assert qt.qweight.dtype == torch.int8 and qt.scales.dtype == torch.float32
    assert (qj.in_features, qj.out_features, qj.out_physical, qj.paired) == \
        (qt.in_features, qt.out_features, qt.out_physical, qt.paired)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("clip", ["none", "auto"])
def test_quantize_weight_bytes_equal(bits, clip):
    _same(*_both(512, 384, seed=bits, bits=bits, group_size=128, clip=clip))


@pytest.mark.parametrize("kw", [
    {"bits": 4, "group_size": 128, "pad_out": 128},     # 300 -> 384 cols
    {"bits": 4, "group_size": 128, "paired": True},
    {"bits": 8, "group_size": 128, "clip": "mse"},
], ids=["pad_out", "paired", "int8_mse"])
def test_quantize_weight_options_bytes_equal(kw):
    qj, qt = _both(512, 300, seed=3, **kw)
    _same(qj, qt)


def test_snapped_group_size():
    qj, qt = _both(704, 256, seed=4, bits=4, group_size=128)
    assert qt.group_size == 64                # 352 packed rows: 128 -> 64
    _same(qj, qt)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_unpack_concat_equal(bits):
    qj, qt = _both(512, 256, seed=5, bits=bits, group_size=128)
    qj2, qt2 = _both(512, 128, seed=6, bits=bits, group_size=128)
    for sdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            np.asarray(jw.dequantize_weight(qj, dtype=sdt), np.float32),
            tw.dequantize_weight(qt, dtype=tdt).float().numpy())
    if bits == 4:
        np.testing.assert_array_equal(
            np.asarray(jw._unpack_int4(qj.qweight)),
            tw._unpack_int4(qt.qweight).numpy())
    cj, ct = jw.concat_qlinear(qj, qj2), tw.concat_qlinear(qt, qt2)
    _same(cj, ct)


def test_padded_and_paired_dequantize_equal():
    for kw in ({"pad_out": 128}, {"paired": True}):
        qj, qt = _both(512, 300, seed=7, bits=4, group_size=128, **kw)
        np.testing.assert_array_equal(
            np.asarray(jw.dequantize_weight(qj), np.float32),
            tw.dequantize_weight(qt).float().numpy())


def test_wo_matmul_small_shape_matches_jax():
    """in < 512: dequantize + matmul on both sides, as on the TPU."""
    qj, qt = _both(256, 128, seed=8, bits=4, group_size=128)
    x = np.random.default_rng(9).standard_normal((2, 256)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(jw.wo_matmul(xj, qj, use_pallas=False), np.float32),
        tw.wo_matmul(xt, qt).float().numpy())


def test_pack_version():
    assert tw.INT4_PACK_VERSION == jw.INT4_PACK_VERSION == 2
