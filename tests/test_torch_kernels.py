"""Plain PyTorch versions of the port's kernels against the JAX package's
Pallas kernels run in interpret mode, on the same seeded inputs.

Tolerances: outputs agree within one bf16 ulp at max|ref| (4e-3 of it:
both sides round f32 sums, taken in another order, to bf16); KV-cache
int8 codes within +-1 (a row scale one ulp apart can move a code across
a rounding boundary) and scales within 1e-6 relative; a bf16 cache row
appended by both sides is equal bit for bit.

Above 256 rows the JAX package runs no kernel (quant_matmul_ref: bf16
dequantized weight, f32 product), and the port's dequant route computes
the same, so those outputs are held to the same one-ulp bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.kernels import attention as att
from infinitensor_tpu.kernels import flash_attention as fa
from infinitensor_tpu.kernels import quant_matmul as qm
from infinitensor_tpu.quant.weight_only import QuantizedLinear as JQ
from infinitensor_tpu.quant.weight_only import quantize_weight
from infinitensor_tpu.utils.config import config

from infinitensor_tpu_torch.kernels import attention as tatt
from infinitensor_tpu_torch.kernels import flash_attention as tfa
from infinitensor_tpu_torch.kernels import quant_matmul as tqm
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy

OUT_TOL = 4e-3


def _t(a):
    return params_from_jax_numpy(np.asarray(a), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=OUT_TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _weights(seed, din=512, dout=384, sdt=jnp.float32, bits=4):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=bits, group_size=128)
    q = JQ(q.qweight, q.scales.astype(sdt), q.bits, q.group_size)
    x = jnp.asarray(rng.standard_normal((3, din)), jnp.bfloat16)
    return rng, q, x


def _port_q(q):
    return params_from_jax_numpy(
        JQ(np.asarray(q.qweight), np.asarray(q.scales), q.bits,
           q.group_size, q.out_logical), "cpu")


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("sdt", [jnp.bfloat16, jnp.float32])
def test_group_matmul_plain_vs_pallas(rows, sdt):
    _, q, x = _weights(1, sdt=sdt)
    x = x[:rows]
    want = qm.quant_matmul(x, q, interpret=True, variant="group")
    got = tqm.quant_matmul(_t(x), _port_q(q), variant="group")
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 3])
def test_group_norm_matmul_plain_vs_pallas(rows):
    rng, q, x = _weights(2, sdt=jnp.bfloat16)
    x = x[:rows] * 3.0
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_w4a8_matmul_plain_vs_pallas(bits):
    _, q, x = _weights(3, sdt=jnp.bfloat16, bits=bits)
    want = qm.quant_matmul(x, q, interpret=True, variant="w4a8")
    got = tqm.quant_matmul(_t(x), _port_q(q), variant="w4a8")
    _close(got, want)


def test_quant_matmul_refuses_what_the_kernel_refuses():
    _, q, x = _weights(4)
    tq = _port_q(q)
    with pytest.raises(ValueError):
        tqm.quant_matmul(_t(x).float(), tq)
    q64 = quantize_weight(jnp.ones((512, 256)), bits=4, group_size=64)
    with pytest.raises(ValueError):
        tqm.quant_matmul(_t(x), _port_q(q64))
    # 257 rows take the dequant route, as the JAX package does: no kernel,
    # nothing refused for want of one
    before = tqm.launches["dequant_matmul"]
    out = tqm.quant_matmul(torch.zeros(257, 512, dtype=torch.bfloat16), tq)
    assert out.shape == (257, 384)
    assert tqm.launches["dequant_matmul"] == before + 1
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(257, 256, dtype=torch.bfloat16), tq)


def _rows300(seed, bits=4):
    rng, q, _ = _weights(seed, sdt=jnp.bfloat16, bits=bits)
    x = jnp.asarray(rng.standard_normal((300, 512)) * 2.0, jnp.bfloat16)
    return rng, q, x


@pytest.mark.parametrize("variant", ["group", "w4a8"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quant_matmul_over_256_rows_vs_jax(variant, bits):
    _, q, x = _rows300(11, bits)
    want = qm.quant_matmul(x, q, interpret=True, variant=variant)
    before = tqm.launches["dequant_matmul"]
    got = tqm.quant_matmul(_t(x), _port_q(q), variant=variant)
    assert tqm.launches["dequant_matmul"] == before + 1
    _close(got, want)
    # JAX there runs quant_matmul_ref, the group semantics, for w4a8 too
    _close(got, qm.quant_matmul_ref(x, q))


def test_quant_matmul_norm_over_256_rows_vs_jax():
    rng, q, x = _rows300(12)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("S", [1, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_vs_pallas(S, causal):
    rng = np.random.default_rng(20 + S)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, S, 128)) * 2.0,
                           jnp.bfloat16) for _ in range(3))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, fa.flash_attention(q, k, v, causal=causal, interpret=True))
    _close(got, fa.mha_ref(q, k, v, causal))


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_decode_plain_vs_pallas(rep):
    rng = np.random.default_rng(30 + rep)
    B, Hkv, S, D = 2, 2, 256, 128
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, 1, D)), jnp.bfloat16)
    kc, vc = (jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
              for _ in range(2))
    pos = jnp.asarray([100, S - 1], jnp.int32)
    want = att.flash_decode(q, kc, vc, pos, seq_block=128, interpret=True)
    got = tatt.flash_decode(*(_t(a) for a in (q, kc, vc, pos)))
    _close(got, want)


def test_decode_attention_gqa_bf16_vs_jax():
    rng = np.random.default_rng(40)
    B, H, Hkv, S, D = 2, 8, 2, 256, 128
    kc, vc = (jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
              for _ in range(2))
    q = jnp.asarray(rng.standard_normal((B, H, 1, D)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), jnp.bfloat16)
            for _ in range(2))
    pos = jnp.asarray([100, S - 1], jnp.int32)
    port_in = [_t(a) for a in (kc, vc, q, k, v, pos)]
    with config.override(pallas_interpret=True):
        want = att.decode_attention_gqa(kc, vc, q, k, v, pos)
    got = tatt.decode_attention_gqa(*port_in)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_f32(g), _f32(w))
    assert got[1] is port_in[0] and got[2] is port_in[1]
    # MHA form: Hkv = H
    q1 = q[:, :Hkv]
    with config.override(pallas_interpret=True):
        want = att.decode_attention(kc, vc, q1, k, v, pos)
    got = tatt.decode_attention(_t(kc), _t(vc), _t(q1), _t(k), _t(v),
                                _t(pos))
    _close(got[0], want[0])


def _q8_cache(rng, B, Hkv, S, D):
    kc = jnp.asarray(rng.integers(-127, 128, (B, Hkv, S, D)), jnp.int8)
    vc = jnp.asarray(rng.integers(-127, 128, (B, Hkv, S, D)), jnp.int8)
    ks = jnp.asarray(rng.uniform(0.005, 0.02, (B, Hkv, S)), jnp.float32)
    vs = jnp.asarray(rng.uniform(0.005, 0.02, (B, Hkv, S)), jnp.float32)
    return kc, vc, ks, vs


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_decode_q8_plain_vs_pallas(rep):
    rng = np.random.default_rng(5 + rep)
    B, Hkv, S, D = 4, 2, 256, 128
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, 1, D)), jnp.bfloat16)
    kc, vc, ks, vs = _q8_cache(rng, B, Hkv, S, D)
    pos = jnp.asarray([0, 5, 200, 255], jnp.int32)
    want = att.flash_decode_q8(q, kc, vc, ks, vs, pos, seq_block=128,
                               interpret=True)
    got = tatt.flash_decode_q8(*(_t(a) for a in (q, kc, vc, ks, vs, pos)))
    _close(got, want)


def _close_cache(got_q, got_s, want_q, want_s):
    dq = np.abs(got_q.numpy().astype(np.int32)
                - np.asarray(want_q).astype(np.int32))
    assert dq.max() <= 1, dq.max()
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-6, atol=0)


def test_append_and_attention_vs_jax():
    rng = np.random.default_rng(9)
    B, H, Hkv, S, D = 2, 4, 2, 256, 128
    kc, vc, ks, vs = _q8_cache(rng, B, Hkv, S, D)
    q = jnp.asarray(rng.standard_normal((B, H, 1, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), jnp.bfloat16)
    pos = jnp.asarray([17, 130], jnp.int32)
    port_in = [_t(a) for a in (kc, vc, ks, vs, q, k, v, pos)]
    with config.override(pallas_interpret=True):
        want = att.decode_attention_gqa_q8(kc, vc, ks, vs, q, k, v, pos)
    got = tatt.decode_attention_gqa_q8(*port_in)
    _close(got[0], want[0])
    _close_cache(got[1], got[3], want[1], want[3])
    _close_cache(got[2], got[4], want[2], want[4])
    # the append wrote in place, at pos only
    assert got[1] is port_in[0] and got[3] is port_in[2]
    np.testing.assert_array_equal(got[1][:, :, :17].numpy(),
                                  np.asarray(kc)[:, :, :17])


# -- paired int4 scales: the slab kernels ------------------------------------

SLAB_CASES = {
    "512x384": dict(din=512, dout=384, group=128),
    # 768 rows at group 256: pairing snaps the group to 128 (3 packed groups)
    "768x256_snapped": dict(din=768, dout=256, group=256),
    "512x200_padded": dict(din=512, dout=200, group=128, pad=128),
}


def _paired(case, seed, sdt=jnp.float32):
    c = dict(dict(pad=0), **SLAB_CASES[case])
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c["din"], c["dout"])).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=4, group_size=c["group"],
                        pad_out=c["pad"], paired=True)
    assert q.paired and q.scales.shape[0] * 2 * q.group_size == c["din"]
    q = JQ(q.qweight, q.scales.astype(sdt), q.bits, q.group_size,
           q.out_logical)
    return rng, c, q


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_slab_matmul_plain_vs_pallas(case, rows):
    rng, c, q = _paired(case, 50)
    x = jnp.asarray(rng.standard_normal((rows, c["din"])), jnp.bfloat16)
    tq = _port_q(q)
    assert tq.paired and tq.group_size == 128
    want = qm.quant_matmul(x, q, interpret=True)
    got = tqm.quant_matmul(_t(x), tq)
    assert got.shape == (rows, c["dout"])
    _close(got, want)
    # a paired weight takes the slab math whatever variant is asked for
    for variant in ("group", "w4a8", "slab"):
        assert torch.equal(tqm.quant_matmul(_t(x), tq, variant=variant), got)
    _close(got, tqm.qmm_slab_plain(_t(x), tq)[:, :c["dout"]], 0)


@pytest.mark.parametrize("sdt", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_slab_norm_matmul_plain_vs_pallas(case, sdt):
    rng, c, q = _paired(case, 51, sdt)
    x = jnp.asarray(rng.standard_normal((3, c["din"])) * 3.0, jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (c["din"],)), jnp.bfloat16)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    assert got.shape == (3, c["dout"])
    _close(got, want)


def test_slab_asked_for_an_unpaired_weight_is_group():
    _, q, x = _weights(52)
    tq = _port_q(q)
    assert not tq.paired
    assert torch.equal(tqm.quant_matmul(_t(x), tq, variant="slab"),
                       tqm.quant_matmul(_t(x), tq, variant="group"))
    _close(tqm.quant_matmul(_t(x), tq, variant="slab"),
           qm.quant_matmul(x, q, interpret=True, variant="slab"))


def test_paired_over_256_rows_takes_dequant_route_vs_jax():
    rng, c, q = _paired("512x200_padded", 53)
    x = jnp.asarray(rng.standard_normal((300, 512)) * 2.0, jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    before = tqm.launches["dequant_matmul"]
    got = tqm.quant_matmul(_t(x), _port_q(q))
    gotn = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    assert tqm.launches["dequant_matmul"] == before + 2
    _close(got, qm.quant_matmul(x, q, interpret=True))
    _close(gotn, qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True))


def test_paired_scale_rows_are_checked():
    _, _, q = _paired("512x384", 54)
    tq = _port_q(q)
    bad = type(tq)(tq.qweight, tq.scales[:1], 4, 128)     # 1 row for 2 groups
    assert not bad.paired
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(1, 512, dtype=torch.bfloat16), bad)


# -- decode attention at GPT-2's head dim -------------------------------------

@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("rep", [1, 2])
def test_flash_decode_head_dim_64_plain_vs_pallas(rep, dtype):
    rng = np.random.default_rng(60 + rep)
    B, Hkv, S, D = 3, 2, 256, 64
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, 1, D)), dtype)
    kc, vc = (jnp.asarray(rng.standard_normal((B, Hkv, S, D)), dtype)
              for _ in range(2))
    pos = jnp.asarray([0, 100, S - 1], jnp.int32)
    want = att.flash_decode(q, kc, vc, pos, seq_block=128, interpret=True)
    got = tatt.flash_decode(*(_t(a) for a in (q, kc, vc, pos)))
    # the plain versions keep the query's dtype, as the JAX functions do
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    _close(got, want, OUT_TOL if dtype == jnp.bfloat16 else 1e-5)
    kq, vq, ks, vs = _q8_cache(rng, B, Hkv, S, D)
    want = att.flash_decode_q8(q, kq, vq, ks, vs, pos, seq_block=128,
                               interpret=True)
    got = tatt.flash_decode_q8(*(_t(a) for a in (q, kq, vq, ks, vs, pos)))
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    _close(got, want, OUT_TOL if dtype == jnp.bfloat16 else 1e-5)
