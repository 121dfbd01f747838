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

import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.kernels import attention as att
from infinitensor_tpu.kernels import flash_attention as fa
from infinitensor_tpu.kernels import paged_attention as pa
from infinitensor_tpu.kernels import quant_matmul as qm
from infinitensor_tpu.models import gpt2 as jg
from infinitensor_tpu.quant.weight_only import QuantizedLinear as JQ
from infinitensor_tpu.quant.weight_only import quantize_weight
from infinitensor_tpu.utils.config import config

from infinitensor_tpu_torch.kernels import attention as tatt
from infinitensor_tpu_torch.kernels import flash_attention as tfa
from infinitensor_tpu_torch.kernels import paged_attention as tpa
from infinitensor_tpu_torch.kernels import quant_matmul as tqm
from infinitensor_tpu_torch.models import gpt2 as tg
from infinitensor_tpu_torch.models.convert import (
    cache_from_jax_numpy, params_from_jax_numpy)

OUT_TOL = 4e-3
ROOT = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("rows", [1, 3, 8, 64, 256])
def test_group_norm_matmul_plain_vs_pallas(rows):
    """qmm_group_plain on rmsnorm_bf16's rows, the function both CUDA
    forms of qmm_group_norm compute, against the interpreted TPU kernel;
    8-256 rows are the shapes its tensor-core form serves (the dense
    serving step's 8 slots up to the kernels' 256 rows)."""
    rng, q, x = _weights(2, sdt=jnp.bfloat16)
    if rows > 3:
        x = jnp.asarray(rng.standard_normal((rows, 512)), jnp.bfloat16)
    x = x[:rows] * 3.0
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("bits,rows", [
    pytest.param(4, 3, id="4"), pytest.param(8, 3, id="8"),
    pytest.param(4, 64, id="4-64rows"), pytest.param(8, 64, id="8-64rows"),
    pytest.param(4, 256, id="4-256rows"),
    pytest.param(8, 256, id="8-256rows")])
def test_w4a8_matmul_plain_vs_pallas(bits, rows):
    """qmm_w4a8_plain, the function both CUDA forms of qmm_w4a8 compute,
    against the interpreted TPU kernel; 64 and 256 rows are the shapes the
    tensor-core form serves (a prompt's lm_head up to 256 rows)."""
    rng, q, x = _weights(3, sdt=jnp.bfloat16, bits=bits)
    if rows != 3:
        x = jnp.asarray(rng.standard_normal((rows, 512)), jnp.bfloat16)
    want = qm.quant_matmul(x, q, interpret=True, variant="w4a8")
    got = tqm.quant_matmul(_t(x), _port_q(q), variant="w4a8")
    assert tqm.route(_t(x), _port_q(q), "w4a8") == ("qmm_w4a8", 0)
    _close(got, want)


def test_quant_matmul_refuses_what_the_kernel_refuses():
    _, q, x = _weights(4)
    tq = _port_q(q)
    with pytest.raises(ValueError):             # integer activations
        tqm.quant_matmul(torch.zeros(1, 512, dtype=torch.int32), tq)
    # a group of 64 computes: the chunk kernel, as in the JAX package
    q64 = quantize_weight(jnp.ones((512, 256)), bits=4, group_size=64)
    assert tqm.route(_t(x), _port_q(q64)) == ("qmm_chunk", 0)
    _close(tqm.quant_matmul(_t(x), _port_q(q64)),
           qm.quant_matmul(x, q64, interpret=True))
    # 257 rows take the dequant route, as the JAX package does: no kernel,
    # nothing refused for want of one
    before = tqm.launches["dequant_matmul"]
    out = tqm.quant_matmul(torch.zeros(257, 512, dtype=torch.bfloat16), tq)
    assert out.shape == (257, 384)
    assert tqm.launches["dequant_matmul"] == before + 1
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(257, 256, dtype=torch.bfloat16), tq)
    with pytest.raises(ValueError, match="variant"):
        tqm.quant_matmul(_t(x), tq, variant="tiles")


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


# The split form of the dense decode attention (flash-decoding): each
# split's partial (acc, m, l), then the fixed-order merge, against the JAX
# kernels in interpret mode. pos 0 leaves one split live; 100 and 130
# spread 101 and 131 rows unevenly over 3 and 8 splits; 255 fills S.
# Tolerance: OUT_TOL, the merge's f32 result rounded to bf16 as the kernel
# writes it.
@pytest.mark.parametrize("splits,pos", [(1, (100, 255)), (3, (0, 100)),
                                        (8, (0, 255)), (8, (130, 7))])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_split_plain_vs_pallas(cache, rep, splits, pos):
    rng = np.random.default_rng(50 + rep + splits)
    B, Hkv, S, D = 2, 2, 256, 128
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, 1, D)), jnp.bfloat16)
    jpos = jnp.asarray(pos, jnp.int32)
    if cache == "bf16":
        kc, vc = (jnp.asarray(rng.standard_normal((B, Hkv, S, D)),
                              jnp.bfloat16) for _ in range(2))
        want = att.flash_decode(q, kc, vc, jpos, seq_block=128,
                                interpret=True)
        part = tatt.flash_decode_split_plain(
            *(_t(a) for a in (q, kc, vc, jpos)), splits)
    else:
        kc, vc, ks, vs = _q8_cache(rng, B, Hkv, S, D)
        want = att.flash_decode_q8(q, kc, vc, ks, vs, jpos, seq_block=128,
                                   interpret=True)
        part = tatt.flash_decode_q8_split_plain(
            *(_t(a) for a in (q, kc, vc, ks, vs, jpos)), splits)
    assert part.shape == (B, Hkv * rep, splits, D + 2)
    n = np.minimum(np.asarray(pos), S - 1) + 1
    empty = (np.arange(splits + 1)[None, 1:] * n[:, None] // splits
             == np.arange(splits)[None] * n[:, None] // splits)
    np.testing.assert_array_equal(part[..., D + 1].numpy() == 0,
                                  np.repeat(empty[:, None], Hkv * rep, 1))
    _close(tatt.flash_decode_merge(part), want)


def test_decode_splits_read_shapes_only():
    """The split count comes from (B, Hkv, S) and the SM count, never pos:
    one captured graph replays one split count while pos moves; at every
    pos the split form equals the unsplit plain version."""
    import inspect
    assert list(inspect.signature(tatt.decode_splits).parameters) == [
        "B", "Hkv", "S", "sms"]
    assert list(inspect.signature(tatt._outputs).parameters) == [
        "q", "k_cache", "splits"]
    assert tatt.decode_splits(1, 32, 1664, 132) > 1       # 7B MHA, bs 1
    assert tatt.decode_splits(1, 8, 1664, 132) > 1        # GQA 32/8
    assert tatt.decode_splits(64, 16, 384, 132) == 1      # GPT-2, 64 slots
    for B, Hkv, S in ((1, 32, 1664), (1, 8, 64), (2, 1, 63), (4, 8, 4096)):
        ns = tatt.decode_splits(B, Hkv, S, 132)
        assert 1 <= ns <= max(1, min(S // tatt.SPLIT_MIN_ROWS,
                                     tatt.SPLIT_MAX))
    rng = np.random.default_rng(60)
    B, Hkv, rep, S, D = 1, 2, 2, 64, 64
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, 1, D))).to(
        torch.bfloat16)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D))).to(
        torch.bfloat16) for _ in range(2))
    for p in range(S):
        pos = torch.tensor([p], dtype=torch.int32)
        _close(tatt.flash_decode_merge(tatt.flash_decode_split_plain(
            q, kc, vc, pos, 5)), tatt.flash_decode_plain(q, kc, vc, pos))


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


# -- the chunk, split-K and fused-norm W4A8 kernels; the variant knobs ------

def _qweights(seed, din, dout, bits, group, rows, pad=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=bits, group_size=group,
                        pad_out=pad)
    x = jnp.asarray(rng.standard_normal((rows, din)) * 2.0, jnp.bfloat16)
    return rng, q, x


@pytest.fixture
def knobs(monkeypatch, tmp_path):
    """set(variant=None, table=None): INFINITPU_QMM_VARIANT and a tuning
    table written to a fresh file (an empty one by default)."""
    def set_(variant=None, table=None):
        if variant is None:
            monkeypatch.delenv("INFINITPU_QMM_VARIANT", raising=False)
        else:
            monkeypatch.setenv("INFINITPU_QMM_VARIANT", variant)
        path = tmp_path / f"tune{len(list(tmp_path.iterdir()))}.json"
        path.write_text(json.dumps(table or {}))
        monkeypatch.setenv("INFINITPU_QMM_TUNE", str(path))
    return set_


CHUNK_CASES = [(bits, group, rows) for bits in (4, 8) for group in (32, 64, 128)
               for rows in (1, 8, 256)]


@pytest.mark.parametrize("bits,group,rows", CHUNK_CASES)
def test_chunk_matmul_plain_vs_pallas(bits, group, rows):
    _, q, x = _qweights(70 + group + rows, 512, 384, bits, group, rows)
    tq = _port_q(q)
    assert tqm.route(_t(x), tq, "chunk") == ("qmm_chunk", 0)
    want = qm.quant_matmul(x, q, interpret=True, variant="chunk")
    got = tqm.quant_matmul(_t(x), tq, variant="chunk")
    _close(got, want)
    _close(got, tqm.qmm_chunk_plain(_t(x), tq), 0)


def test_chunk_matmul_padded_dout_plain_vs_pallas():
    _, q, x = _qweights(71, 512, 200, 4, 64, 3, pad=128)
    tq = _port_q(q)
    assert tq.out_physical == 256
    got = tqm.quant_matmul(_t(x), tq)            # group 64 -> chunk
    assert got.shape == (3, 200)
    _close(got, qm.quant_matmul(x, q, interpret=True))


@pytest.mark.parametrize("kb", [128, 256])
@pytest.mark.parametrize("bits", [4, 8])
def test_group2d_matmul_plain_vs_pallas(bits, kb, knobs):
    _, q, x = _qweights(80 + kb, 1024, 384, bits, 128, 3)
    tq = _port_q(q)
    want = qm.quant_matmul_2d(x, q, 128, kb, interpret=True)
    got = tqm.qmm_group2d_plain(_t(x), tq, kb)[:, :384]
    _close(got, want)
    # a table entry in the form tools/qmm_tune.py writes routes to it
    knobs(table={f"1024:384:{bits}": {"variant": "group2d", "bn": 128,
                                      "kb": kb}})
    assert tqm.route(_t(x), tq) == ("qmm_group2d", kb)
    assert torch.equal(tqm.quant_matmul(_t(x), tq), got)
    _close(got, qm.quant_matmul(x, q, interpret=True))


W4A8_FUSED_TOL = 2e-2


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("bits", [4, 8])
def test_norm_w4a8_matmul_plain_vs_pallas(bits, rows, knobs):
    """Within one bf16 ulp of the JAX package's composition (its RMSNorm
    rounded as _kernel_group_norm_w4a8 writes it, then its interpreted
    W4A8 kernel), and within W4A8_FUSED_TOL of max|out| of the interpreted
    fused kernel: on the CPU XLA keeps that kernel's normalized row in f32
    (xla_allow_excess_precision, on by default), which moves a few percent
    of the int8 activation codes by one (measured: 0.75 at max|out| 85;
    with the flag off the two are equal bit for bit). The JAX package holds
    its fused kernel to its composition within 3e-2
    (tests/test_pallas_interpret.py)."""
    import jax
    rng, q, x = _qweights(90 + rows, 512, 256, bits, 128, rows)
    x = x * 3.0
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    knobs(variant="w4a8")                 # empty table: the env var decides
    tq = _port_q(q)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), tq, eps=1e-5)
    assert torch.equal(got, tqm.qmm_norm_w4a8_plain(_t(x), _t(nw), tq, 1e-5))
    x32 = x.astype(jnp.float32)
    ms = jnp.mean(jnp.square(x32), axis=-1, keepdims=True)
    xn = (x32 * jax.lax.rsqrt(ms + 1e-5)).astype(jnp.bfloat16) * nw
    _close(got, qm.quant_matmul(xn, q, interpret=True, variant="w4a8"))
    _close(got, qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True),
           W4A8_FUSED_TOL)


def _fake(din, dout, bits=4, group=128):
    """A weight of the right shapes for route(); its values do not matter."""
    rows = din // 2 if bits == 4 else din
    return tqm.QuantizedLinear(torch.zeros(rows, dout, dtype=torch.int8),
                               torch.ones(din // group, dout), bits, group)


def test_variant_precedence_quant_matmul(knobs, monkeypatch):
    """caller > table entry > INFINITPU_QMM_VARIANT > "group"."""
    q, x = _fake(512, 384), torch.zeros(1, 512, dtype=torch.bfloat16)
    knobs()
    assert tqm.route(x, q)[0] == "qmm_group"
    knobs(variant="w4a8")
    assert tqm.route(x, q)[0] == "qmm_w4a8"
    knobs(variant="w4a8", table={"512:384:4": {"variant": "chunk"}})
    assert tqm.route(x, q)[0] == "qmm_chunk"
    assert tqm.route(x, q, "group")[0] == "qmm_group"
    # group2d: only with a kb that fits and a bn dividing the columns
    for entry, want in (({"variant": "group2d", "bn": 128, "kb": 128},
                         ("qmm_group2d", 128)),
                        ({"variant": "group2d", "bn": 128}, ("qmm_group", 0)),
                        ({"variant": "group2d", "bn": 256, "kb": 128},
                         ("qmm_group", 0)),
                        ({"variant": "group2d", "bn": 128, "kb": 192},
                         ("qmm_group", 0))):
        knobs(table={"512:384:4": entry})
        assert tqm.route(x, q) == want, entry
    # no multiple of 128 as the group: chunk, whatever was asked
    knobs(variant="w4a8")
    assert tqm.route(x, _fake(512, 384, group=64))[0] == "qmm_chunk"
    assert tqm.route(x, _fake(512, 384, group=64), "group")[0] == "qmm_chunk"
    # a missing or unreadable table is an empty one
    for bad in ("/nonexistent/tune.json", __file__):
        monkeypatch.setenv("INFINITPU_QMM_TUNE", bad)
        assert tqm.route(x, q)[0] == "qmm_w4a8"


def test_default_table_wins_over_the_env_var(monkeypatch):
    """The port's own table lists "group" for the four 7B layer shapes and
    "w4a8" for the lm_head; the env var does not override an entry."""
    monkeypatch.delenv("INFINITPU_QMM_TUNE", raising=False)
    monkeypatch.setenv("INFINITPU_QMM_VARIANT", "w4a8")
    with open(ROOT / "docs" / "qmm_tune.json") as f:
        assert tqm._load_tune(tqm.TUNE_DEFAULT) == json.load(f)
    x, x11 = (torch.zeros(1, d, dtype=torch.bfloat16) for d in (4096, 11008))
    assert tqm.route(x, _fake(4096, 12288))[0] == "qmm_group"
    assert tqm.route(x, _fake(4096, 4096))[0] == "qmm_group"
    assert tqm.route(x11, _fake(11008, 4096))[0] == "qmm_group"
    assert tqm.route(x, _fake(4096, 4000))[0] == "qmm_w4a8"   # not listed
    monkeypatch.delenv("INFINITPU_QMM_VARIANT")
    assert tqm.route(x, _fake(4096, 32000))[0] == "qmm_w4a8"


def test_variant_precedence_quant_matmul_norm(knobs):
    """table entry > INFINITPU_QMM_VARIANT > "group", no caller argument;
    each setting against the JAX package on the same knobs."""
    rng, q, x = _qweights(95, 512, 256, 4, 128, 2)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.bfloat16)
    tq, tx, tnw = _port_q(q), _t(x), _t(nw)
    w4a8 = tqm.qmm_norm_w4a8_plain(tx, tnw, tq, 1e-5)
    group = tqm.qmm_group_plain(tqm.rmsnorm_bf16(tx, tnw, 1e-5), tq)
    for variant, table, want in (
            (None, None, group), ("w4a8", None, w4a8),
            (None, {"512:256:4": {"variant": "w4a8"}}, w4a8),
            ("w4a8", {"512:256:4": {"variant": "group"}}, group)):
        knobs(variant=variant, table=table)
        got = tqm.quant_matmul_norm(tx, tnw, tq, eps=1e-5)
        assert torch.equal(got, want), (variant, table)
        _close(got, qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True),
               W4A8_FUSED_TOL if want is w4a8 else OUT_TOL)


@pytest.mark.parametrize("case", ["group64", "odd_scale_rows", "f32_x"])
def test_quant_matmul_norm_falls_back_as_jax(case):
    """rmsnorm + quant_matmul where the fused kernels do not apply: a group
    of 64 (chunk), a group dividing no packed row count (dequant route,
    din 1376 snaps to 32), an f32 x (the CPU's dequant route)."""
    din, group, dt = {"group64": (512, 64, jnp.bfloat16),
                      "odd_scale_rows": (1376, 64, jnp.bfloat16),
                      "f32_x": (512, 128, jnp.float32)}[case]
    rng, q, x = _qweights(96, din, 256, 4, group, 3)
    x = x.astype(dt)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (din,)), jnp.bfloat16)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5, interpret=True)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    assert got.dtype == (torch.float32 if case == "f32_x" else torch.bfloat16)
    _close(got, want)


def test_wo_matmul_takes_w4a8_below_512_under_the_env_var(knobs):
    """weight_only.py:276-282: the W4A8 math on every shape; at din 256
    the JAX package runs its W4A8 kernel, where without the env var both
    take dequantize + matmul."""
    from infinitensor_tpu.quant.weight_only import wo_matmul as jwo
    from infinitensor_tpu_torch.quant.weight_only import wo_matmul
    _, q, x = _qweights(97, 256, 256, 4, 128, 3)
    tq = _port_q(q)
    knobs(variant="w4a8")
    with config.override(pallas_interpret=True):
        want = jwo(x, q)
    got = wo_matmul(_t(x), tq)
    _close(got, want)
    _close(got, qm.quant_matmul_w4a8_ref(x, q))
    assert torch.equal(got, tqm.qmm_w4a8_plain(_t(x), tq))
    assert not torch.equal(got, tqm.qmm_group_plain(_t(x), tq))
    # quant_matmul itself, same knob: W4A8 where the parent gave group math
    assert torch.equal(tqm.quant_matmul(_t(x), tq), got)
    knobs()
    assert torch.equal(wo_matmul(_t(x), tq),
                       tqm.dequant_matmul(_t(x), tq))


# -- f32 activations and odd physical columns (ROADMAP Queue 3 items 1, 3) --

F32_TOL = 1e-5      # f32 on both sides; only the summation order differs


@pytest.mark.parametrize("variant", ["group", "w4a8"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("sdt", [jnp.bfloat16, jnp.float32])
def test_f32_quant_matmul_vs_jax(variant, bits, sdt):
    """An f32 x computes in f32, as the JAX package's off-chip path does:
    the dequant route, or quant_matmul_w4a8_ref under "w4a8"; and it
    agrees with the interpreted TPU kernel, which takes an f32 x."""
    rng, q, _ = _weights(21, sdt=sdt, bits=bits)
    x = jnp.asarray(rng.standard_normal((3, 512)), jnp.float32)
    tq = _port_q(q)
    assert tqm.route(_t(x), tq, variant)[0] == (
        "w4a8_ref" if variant == "w4a8" else "dequant_matmul")
    got = tqm.quant_matmul(_t(x), tq, variant=variant)
    assert got.dtype == torch.float32 and got.shape == (3, 384)
    _close(got, qm.quant_matmul(x, q, variant=variant), F32_TOL)
    _close(got, qm.quant_matmul(x, q, interpret=True, variant=variant),
           F32_TOL if variant == "group" else OUT_TOL)


def test_f32_quant_matmul_norm_vs_jax():
    """quant_matmul_norm on an f32 x: norm + quant_matmul in f32, as the
    JAX package's fallback computes it."""
    rng, q, _ = _weights(22, sdt=jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((2, 512)) * 3.0, jnp.float32)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.float32)
    want = qm.quant_matmul_norm(x, nw, q, eps=1e-5)
    got = tqm.quant_matmul_norm(_t(x), _t(nw), _port_q(q), eps=1e-5)
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_odd_physical_columns_vs_jax():
    """A weight of 1002 physical columns (no multiple of 4) takes the
    dequant route with a bf16 x, as the JAX kernels refuse it for want of
    a 128-column tile and take quant_matmul_ref."""
    rng = np.random.default_rng(23)
    q = quantize_weight(jnp.asarray(rng.standard_normal((512, 1002)),
                                    jnp.float32), 4, 128)
    x = jnp.asarray(rng.standard_normal((1, 512)), jnp.bfloat16)
    tq = _port_q(q)
    assert tq.out_physical == 1002
    assert tqm.route(_t(x), tq) == ("dequant_matmul", 0)
    got = tqm.quant_matmul(_t(x), tq)
    assert got.shape == (1, 1002) and got.dtype == torch.bfloat16
    _close(got, qm.quant_matmul(x, q))
    _close(got, qm.quant_matmul(x, q, interpret=True))


# -- f16 activations and the two forms of qmm_group --------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 8, 64])
def test_f16_group_plain_vs_pallas(bits, rows):
    """qmm_group_plain, the function both CUDA forms of qmm_group compute,
    with an f16 x against the interpreted TPU kernel, which takes an f16 x
    (its dot of f16 and the bf16-cast weight sums in f32) and writes f16.
    OUT_TOL: both sides round f32 sums, taken in another order, to f16."""
    rng, q, _ = _weights(24, sdt=jnp.bfloat16, bits=bits)
    x = jnp.asarray(rng.standard_normal((rows, 512)), jnp.float16)
    want = qm.quant_matmul(x, q, interpret=True, variant="group")
    got = tqm.qmm_group_plain(_t(x), _port_q(q))[:, :384]
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _close(got, want)


@pytest.mark.parametrize("variant", ["group", "w4a8"])
@pytest.mark.parametrize("bits", [4, 8])
def test_f16_quant_matmul_on_the_cpu_vs_jax(variant, bits):
    """On the CPU an f16 x takes the JAX package's off-chip math, as an
    f32 x does: the dequant route, or quant_matmul_w4a8_ref under "w4a8",
    in f16."""
    rng, q, _ = _weights(25, sdt=jnp.bfloat16, bits=bits)
    x = jnp.asarray(rng.standard_normal((3, 512)), jnp.float16)
    tq = _port_q(q)
    assert tqm.route(_t(x), tq, variant)[0] == (
        "w4a8_ref" if variant == "w4a8" else "dequant_matmul")
    got = tqm.quant_matmul(_t(x), tq, variant=variant)
    assert got.dtype == torch.float16 and got.shape == (3, 384)
    _close(got, qm.quant_matmul(x, q, variant=variant))


@pytest.mark.parametrize("rows,dtype,norm,form", [
    (1, torch.bfloat16, False, "cuda_core"),
    (tqm.MMA_MIN_ROWS - 1, torch.bfloat16, False, "cuda_core"),
    (tqm.MMA_MIN_ROWS, torch.bfloat16, False, "mma"),
    (tqm.MMA_MIN_ROWS, torch.float16, False, "mma"),
    (256, torch.float16, False, "mma"),
    (256, torch.float32, False, "cuda_core"),
    (64, torch.float32, False, "cuda_core"),
    (64, torch.bfloat16, True, "mma"),
    (256, torch.bfloat16, True, "mma"),
    (1, torch.bfloat16, True, "cuda_core"),
    (tqm.MMA_MIN_ROWS, torch.float32, True, "cuda_core"),
])
def test_group_form(rows, dtype, norm, form):
    """The form a qmm_group launch on the card takes: the tensor cores
    from MMA_MIN_ROWS rows for a bf16 or f16 x without a norm and for a
    bf16 x with the fused RMSNorm (qmm_group_norm_mma); the CUDA cores
    for an f32 x (its numbers stay f32) or fewer rows."""
    assert 1 <= tqm.MMA_MIN_ROWS <= tqm.KERNEL_MAX_ROWS
    assert tqm.group_form(rows, dtype, norm) == form


@pytest.mark.parametrize("rows", [1, 8, 9, 33, 64, 100, 256])
@pytest.mark.parametrize("dout_p,krows", [(4096, 2048), (12288, 2048),
                                          (1024, 1024), (51200, 1024),
                                          (260, 512)])
def test_mma_plan(rows, dout_p, krows):
    """qmm_group_mma's launch plan: a row tile that the C entry takes and
    that holds the rows up to 64, at most one split per scale group of
    128, a split only where the column and row tiles leave blocks short
    of the target, and then enough splits to reach it where the groups
    allow."""
    sms = 132
    tile, splits = tqm.mma_plan(rows, dout_p, krows, 128, sms)
    assert tile in tqm.MMA_ROW_TILES
    assert tile >= min(rows, 32) and (rows > 64) == (tile == 64)
    blocks = -(-dout_p // tqm.MMA_COLS) * -(-rows // tile)
    target = sms if tile == 64 else 2 * sms
    assert 1 <= splits <= krows // 128
    assert splits == 1 or blocks < target
    assert blocks >= target or splits == krows // 128 \
        or blocks * splits >= target


@pytest.mark.parametrize("rows,dtype,form", [
    (1, torch.bfloat16, "cuda_core"),
    (tqm.W4A8_MMA_MIN_ROWS - 1, torch.bfloat16, "cuda_core"),
    (tqm.W4A8_MMA_MIN_ROWS, torch.bfloat16, "mma"),
    (tqm.W4A8_MMA_MIN_ROWS, torch.float32, "mma"),
    (8, torch.bfloat16, "mma"),
    (256, torch.float32, "mma"),
    (256, torch.float16, "cuda_core"),
    (1, torch.float32, "cuda_core"),
])
@pytest.mark.parametrize("bits", [4, 8])
def test_w4a8_form(rows, dtype, form, bits):
    """The form a qmm_w4a8 launch on the card takes: the int8 tensor
    cores for a bf16 or f32 x from W4A8_MMA_MIN_ROWS rows (at least 2, so
    the batch-1 decode and the W4A8 knob's 1-row launches keep the
    CUDA-core form), for int4 and int8 weights alike; an f16 x never
    reaches qmm_w4a8 (route sends it to qmm_group)."""
    assert 2 <= tqm.W4A8_MMA_MIN_ROWS <= tqm.KERNEL_MAX_ROWS
    assert tqm.w4a8_form(rows, dtype) == form
    q = _fake(4096, 32000, bits=bits)
    x = torch.zeros(rows, 4096, dtype=dtype, device="meta")
    assert tqm.route(x, q, "w4a8")[0] == (
        "qmm_group" if dtype == torch.float16 else "qmm_w4a8")


@pytest.mark.parametrize("rows,dtype,form", [
    (1, torch.bfloat16, "cuda_core"),
    (tqm.MMA_MIN_ROWS - 1, torch.bfloat16, "cuda_core"),
    (tqm.MMA_MIN_ROWS, torch.bfloat16, "mma"),
    (8, torch.bfloat16, "mma"),
    (64, torch.bfloat16, "mma"),
    (256, torch.bfloat16, "mma"),
    (64, torch.float32, "cuda_core"),
])
def test_ln_form(rows, dtype, form):
    """The form a qmm_group_ln launch on the card takes: qmm_group_mma's
    tile behind a LayerNorm pre-pass for a bf16 x from MMA_MIN_ROWS rows,
    the CUDA-core form at one row (quant_matmul_ln sends no other dtype
    to qmm_group_ln)."""
    assert tqm.ln_form(rows, dtype) == form


@pytest.mark.parametrize("rows,dout_p,krows,tile,splits", [
    (256, 32000, 2048, 64, 1),      # Llama-2-7B lm_head, a 256-token prompt
    (64, 32000, 2048, 32, 1),
    (8, 32000, 2048, 8, 2),         # the paged step's lm_head (8 slots)
    (5, 32000, 2048, 8, 2),
    (8, 4096, 2048, 8, 9),          # wo under the W4A8 knob, 8 rows
    (8, 4096, 5504, 8, 9),          # w_down
    (64, 3072, 1024, 32, 6),        # GPT-2 345M w_qkv, 64 rows
    (64, 4096, 1024, 32, 5),        # GPT-2 345M w_up
    (64, 51200, 1024, 32, 1),       # GPT-2 345M lm_head
    (256, 260, 512, 64, 4),         # a narrow dout: split by every group
])
def test_w4a8_and_ln_plan(rows, dout_p, krows, tile, splits):
    """The launch plan of qmm_w4a8_mma (Llama's lm_head at a prompt's 64
    and 256 rows and the paged step's 8, the W4A8 knob's wo and w_down)
    and of qmm_group_ln_mma (GPT-2's w_qkv and w_up at 64 slots):
    mma_plan, as for qmm_group_mma, on the card's 132 SMs."""
    assert tqm.mma_plan(rows, dout_p, krows, 128, 132) == (tile, splits)


# -- the attention kernels at every float type and head dim: the plain ------
# -- versions the CPU takes (and the card's any-type form is held to) ------
# -- against the JAX kernels in interpret mode, in q's dtype ----------------
# Tolerance: 1e-5 of max|ref| in f32 (both sides f32, sums in another
# order); one bf16 ulp (OUT_TOL) in bf16 and f16, the f32 result rounded
# to q's dtype on both sides.

ANY_TYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
             "f16": (jnp.float16, torch.float16, OUT_TOL),
             "bf16": (jnp.bfloat16, torch.bfloat16, OUT_TOL)}


@pytest.mark.parametrize("dtype,D", [("f32", 16), ("f16", 64), ("bf16", 8),
                                     ("bf16", 256), ("f32", 96),
                                     ("f16", 128), ("f16", 72), ("f16", 96)])
def test_flash_decode_any_type_plain_vs_pallas(dtype, D):
    jdt, tdt, tol = ANY_TYPES[dtype]
    rng = np.random.default_rng(80 + D)
    B, Hkv, rep, S = 2, 2, 2, 128
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, 1, D)), jdt)
    kc, vc = (jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jdt)
              for _ in range(2))
    pos = jnp.asarray([37, S - 1], jnp.int32)
    want = att.flash_decode(q, kc, vc, pos, seq_block=64, interpret=True)
    got = tatt.flash_decode(*(_t(a) for a in (q, kc, vc, pos)))
    assert got.dtype == tdt
    _close(got, want, tol)
    # the split form's partials and merge, in q's dtype
    part = tatt.flash_decode_split_plain(*(_t(a) for a in (q, kc, vc, pos)),
                                         3)
    _close(tatt.flash_decode_merge(part, tdt), want, tol)
    kq, vq, ks, vs = _q8_cache(rng, B, Hkv, S, D)
    want = att.flash_decode_q8(q, kq, vq, ks, vs, pos, seq_block=64,
                               interpret=True)
    got = tatt.flash_decode_q8(*(_t(a) for a in (q, kq, vq, ks, vs, pos)))
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,D", [("f32", 16), ("f16", 64), ("bf16", 96),
                                     ("bf16", 8), ("f32", 256), ("f16", 72),
                                     ("f16", 96)])
def test_flash_attention_any_type_plain_vs_pallas(dtype, D, causal):
    jdt, tdt, tol = ANY_TYPES[dtype]
    rng = np.random.default_rng(90 + D)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 128, D)) * 2.0, jdt)
               for _ in range(3))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == tdt
    _close(got, fa.flash_attention(q, k, v, causal=causal, block_q=64,
                                   block_k=64, interpret=True), tol)


# The route of the attention wrappers on the card, read from its
# predicates (no launch): the fast decode kernels take a bf16 or f16 q over
# a cache of its own dtype or int8 at D 64 and 128; the tensor-core
# prefill takes bf16 or f16 at D up to 128; everything else takes the
# any-type form.
ROUTE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
                "f32": torch.float32}
OTHER_FLOAT = {"bf16": torch.float16, "f16": torch.bfloat16,
               "f32": torch.bfloat16}
FAST_DECODE = {("bf16", "same"), ("bf16", "int8"), ("f16", "same"),
               ("f16", "int8")}


@pytest.mark.parametrize("D", [8, 16, 64, 72, 96, 128, 136, 256])
@pytest.mark.parametrize("cache", ["same", "int8", "other"])
@pytest.mark.parametrize("q", ["bf16", "f16", "f32"])
def test_attention_route(q, cache, D):
    qdt = ROUTE_DTYPES[q]
    cdt = {"same": qdt, "int8": torch.int8, "other": OTHER_FLOAT[q]}[cache]
    assert tatt.fast_form(qdt, cdt, D) == (
        (q, cache) in FAST_DECODE and D in (64, 128))
    assert tatt.fast_prefill(qdt, D) == (q in ("bf16", "f16") and D <= 128)


@pytest.mark.parametrize("qdt,pdt", [("f16", "f16"), ("f16", "bf16"),
                                     ("f32", "f32")])
def test_paged_decode_head_dim_64_any_type_plain_vs_pallas(qdt, pdt):
    """Both paged kernels at head dim 64 (the paged engine of a model with
    64-wide heads) with an f16 or f32 q."""
    jq, tq, tol = ANY_TYPES[qdt]
    jp = ANY_TYPES[pdt][0]
    rng = np.random.default_rng(95)
    B, H, Hkv, D, P, N = 2, 4, 2, 64, 16, 9
    q = jnp.asarray(rng.standard_normal((B, H, 1, D)), jq)
    kp, vp = (jnp.asarray(rng.standard_normal((N, Hkv, P, D)), jp)
              for _ in range(2))
    table = jnp.asarray([[3, 0, 5, 8], [7, 2, 1, 4]], jnp.int32)
    pos = jnp.asarray([20, 4 * P - 1], jnp.int32)
    want = pa.paged_flash_decode(q, kp, vp, table, pos, interpret=True)
    got = tpa.paged_flash_decode(*(_t(a) for a in (q, kp, vp, table, pos)))
    assert got.dtype == tq
    _close(got, want, tol)
    kq = jnp.asarray(rng.integers(-127, 128, (N, Hkv, P, D)), jnp.int8)
    vq = jnp.asarray(rng.integers(-127, 128, (N, Hkv, P, D)), jnp.int8)
    ks, vs = (jnp.asarray(rng.uniform(0.005, 0.02, (N, Hkv, P)),
                          jnp.float32) for _ in range(2))
    want = pa.paged_flash_decode_q8(q, kq, vq, ks, vs, table, pos,
                                    interpret=True)
    got = tpa.paged_flash_decode_q8(*(_t(a) for a in (q, kq, vq, ks, vs,
                                                      table, pos)))
    assert got.dtype == tq
    _close(got, want, tol)


@pytest.mark.parametrize("rows,dout_p,krows,group,splits", [
    (1, 4096, 2048, 128, 8),      # wo, int4: 32 tiles
    (1, 4096, 5504, 128, 8),      # w_down
    (1, 4096, 2048, 64, 8),       # wo at group 64 (qmm_chunk)
    (1, 12288, 2048, 64, 2),      # wqkv at group 64: 96 tiles
    (1, 22528, 2048, 64, 1),      # w_gateup: 176 tiles fill the card
    (1, 32000, 2048, 128, 1),     # lm_head
    (8, 4096, 2048, 64, 1),       # wo at 8 rows: 4-row blocks stay whole
    (4, 4096, 2048, 64, 1),
    (3, 4096, 2048, 128, 4),      # 3 rows: two row blocks of 2
    (8, 12288, 2048, 64, 1),
    (2, 4096, 2048, 128, 8),      # 2 rows: one row block
    (1, 512, 256, 128, 2),        # two scale groups cap the split
    (1, 768, 256, 64, 4),         # entry()'s wqkv: four groups
    (256, 4096, 2048, 128, 1),
])
def test_group_splits(rows, dout_p, krows, group, splits):
    """The split form of a short grid comes from shapes only: a power
    of two, at most SPLIT_MAX and the scale groups, the most that keeps
    column tiles x row blocks x splits within two CTAs an SM, 1 (the
    unsplit form) from 4 rows on, where a block holds 4 rows."""
    got = tqm.group_splits(rows, dout_p, krows, group, 132)
    assert got == splits
    assert got & (got - 1) == 0 and got <= tqm.SPLIT_MAX
    assert got <= max(1, krows // group)


# -- qmm_group_ln at one row: the K split of a short grid ------------------
# GPT-2 345M's fused LayerNorm matmuls (int8, group 128, din 1024) at
# batch 1 take the CUDA-core form, and its K split from the shapes and the
# SM count alone (132 on the H100); from MMA_MIN_ROWS rows the
# tensor-core form, whose plan is mma_plan's.

@pytest.mark.parametrize("rows,dout_p,form,splits", [
    (1, 3072, "cuda_core", 8),      # w_qkv: 24 tiles -> 192 blocks
    (1, 4096, "cuda_core", 8),      # w_up: 32 tiles -> 256 blocks
    (4, 3072, "mma", 1),            # 4 rows and more: no split
    (4, 4096, "mma", 1),
    (64, 3072, "mma", 1),
])
def test_group_ln_split_plan(rows, dout_p, form, splits):
    assert tqm.ln_form(rows, torch.bfloat16) == form
    assert tqm.group_splits(rows, dout_p, 1024, 128, 132) == splits


class _FakeLib:
    """Records the arguments of a qmm_group_ln launch (no card here)."""

    def __init__(self):
        self.calls = []

    def qmm_group_ln(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dout,forced,splits", [
    (3072, None, 8), (4096, None, 8), (3072, 1, 1), (4096, 2, 2)])
def test_group_ln_launch_takes_the_split_plan(dout, forced, splits,
                                              monkeypatch):
    """The CUDA-core launch of qmm_group_ln passes _split_plan's count
    (group_splits on the card's SMs, or _SPLITS where set), its f32
    partials [splits, rows, dout_p] and the tile counters, and counts a
    split launch again as qmm_group_ln_split. Read through a stand-in for
    the library: the arguments, not the kernel."""
    lib = _FakeLib()
    monkeypatch.setattr(tqm, "_lib_fused", lambda: lib)
    monkeypatch.setattr(tqm._build, "sms", lambda index: 132)
    monkeypatch.setattr(tqm._build, "stream", lambda: None)
    counters = torch.zeros(4096, dtype=torch.int32)
    monkeypatch.setattr(tqm, "_counters", lambda device, need: counters)
    monkeypatch.setattr(tqm, "_SPLITS", forced)
    rng = np.random.default_rng(dout)
    q = quantize_weight(jnp.asarray(rng.standard_normal((1024, dout)),
                                    jnp.float32), bits=8, group_size=128)
    q = _port_q(q)
    x = torch.from_numpy(rng.standard_normal((1, 1024))).to(torch.bfloat16)
    g = torch.ones(1024, dtype=torch.bfloat16)
    b = torch.zeros(1024, dtype=torch.bfloat16)
    bias = torch.zeros(dout, dtype=torch.bfloat16)
    before = dict(tqm.launches)
    tqm._launch_group_ln(x, g, b, q, bias, 1e-5)
    (args,) = lib.calls
    assert args[17] == splits                 # splits, then part, counters
    assert (args[18].value is None) == (splits == 1)
    assert (args[19].value == counters.data_ptr()) == (splits > 1)
    assert tqm.launches["qmm_group_ln"] == before.get("qmm_group_ln", 0) + 1
    assert tqm.launches["qmm_group_ln_split"] == \
        before.get("qmm_group_ln_split", 0) + (splits > 1)


GPT2_TINY = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, max_seq=64)


def test_gpt2_decode_step_at_batch_1_vs_jax():
    """gpt2_decode_step at batch 1 (on the card its w_qkv and w_up take
    qmm_group_ln's K split) against the JAX decode step, an int8 model at
    a tiny config, the JAX side's Pallas kernels in interpret mode: three
    steps from one prefill, each from the JAX cache, logits within 3e-2 of
    max|logit| (bf16 activations, int8 weights, sums in another order)
    and the same argmax or a near-tie within that error."""
    cfg_j = jg.GPT2Config(**GPT2_TINY)
    dense = jg.init_gpt2_params(cfg_j, jax.random.PRNGKey(3))
    rng = np.random.default_rng(13)
    for layer in dense["layers"]:   # biases and LayerNorm vectors off 0 / 1
        for k in layer:
            if k.startswith("b_") or k.endswith("_b"):
                layer[k] = jnp.asarray(
                    rng.standard_normal(layer[k].shape) * 0.05, jnp.bfloat16)
            elif k.endswith("_g"):
                layer[k] = jnp.asarray(
                    rng.uniform(0.8, 1.2, layer[k].shape), jnp.bfloat16)
    params_j = jg.quantize_gpt2_params(dense, bits=8, group_size=128)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    cfg_t = tg.GPT2Config(**GPT2_TINY)
    S = 9
    tokens = rng.integers(0, cfg_j.vocab_size, (1, S)).astype(np.int32)
    cache_j = jg.init_gpt2_cache(cfg_j, 1)
    with config.override(pallas_interpret=True):
        _, cache_j = jg.gpt2_prefill(params_j, cfg_j, jnp.asarray(tokens),
                                     cache_j)
    for step in range(3):
        cache_t = cache_from_jax_numpy(jax.tree.map(np.asarray, cache_j),
                                       "cpu")
        tok = rng.integers(0, cfg_j.vocab_size, (1,)).astype(np.int32)
        pos = np.asarray([S + step], np.int32)
        with config.override(pallas_interpret=True):
            lj, cache_j = jg.gpt2_decode_step(
                params_j, cfg_j, jnp.asarray(tok), jnp.asarray(pos), cache_j)
        lt, _ = tg.gpt2_decode_step(params_t, cfg_t, torch.from_numpy(tok),
                                    torch.from_numpy(pos), cache_t)
        lt, lj = _f32(lt), _f32(lj)
        assert lt.shape == lj.shape == (1, cfg_t.vocab_size)
        err = np.max(np.abs(lt - lj))
        assert err <= 3e-2 * np.max(np.abs(lj)), (step, err)
        at, aj = int(lt.argmax()), int(lj.argmax())
        assert lj[0, aj] - lj[0, at] <= err, (step, at, aj)
