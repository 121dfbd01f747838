"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where CUDA is unavailable. On a machine with a card and no
jax, run without the repository's conftest (which imports jax):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerance: within 1e-2 of max|plain| (both sides round f32 sums, taken
in another order, to bf16; flash_attention also rounds P to bf16 for its
tensor-core product); graph and eager decode give equal tokens, and so do
the paged and the dense serving engine.
"""

import json
import math

import numpy as np
import pytest
import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.kernels import attention as att
from infinitensor_tpu_torch.kernels import flash_attention as fa
from infinitensor_tpu_torch.kernels import paged_attention as pa
from infinitensor_tpu_torch.kernels import quant_matmul as qm
from infinitensor_tpu_torch.models import llama
from infinitensor_tpu_torch.quant.weight_only import (
    QuantizedLinear, dequantize_weight, quantize_weight)
from infinitensor_tpu_torch.serving import PagedServingEngine, ServingEngine

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item(), err


def _qlin(dev, din, dout, bits, sdt, pad_out=0, seed=0, group=128):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(din, dout, generator=g)
    q = quantize_weight(w, bits=bits, group_size=group, pad_out=pad_out)
    return QuantizedLinear(q.qweight.to(dev), q.scales.to(sdt).to(dev),
                           q.bits, q.group_size, q.out_logical)


def _x(dev, rows, din, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, din, generator=g).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_group_kernel(dev, rows, bits, sdt):
    q = _qlin(dev, 1024, 260, bits, sdt)
    x = _x(dev, rows, 1024)
    _close(qm.quant_matmul(x, q, variant="group"), qm.qmm_group_plain(x, q))
    nw = (torch.rand(1024, generator=torch.Generator().manual_seed(2))
          + 0.5).to(torch.bfloat16).to(dev)
    _close(qm.quant_matmul_norm(x * 4, nw, q),
           qm.qmm_group_plain(qm.rmsnorm_bf16(x * 4, nw, 1e-5), q))


@pytest.mark.parametrize("bits", [4, 8])
def test_group_and_w4a8_kernels_at_256_rows(dev, bits):
    """A 256-token prompt's matmuls: the most rows a kernel takes."""
    q = _qlin(dev, 4096, 512, bits, torch.bfloat16)
    x = _x(dev, 256, 4096)
    before = dict(qm.launches)
    _close(qm.quant_matmul(x, q, variant="group"), qm.qmm_group_plain(x, q))
    _close(qm.quant_matmul(x, q, variant="w4a8"), qm.qmm_w4a8_plain(x, q))
    assert qm.launches["qmm_group"] == before.get("qmm_group", 0) + 1
    assert qm.launches["qmm_w4a8"] == before.get("qmm_w4a8", 0) + 1
    # one more row takes the dequant route, as in the JAX package
    x = _x(dev, 257, 4096)
    got = qm.quant_matmul(x, q, variant="w4a8")
    assert qm.launches["dequant_matmul"] == \
        before.get("dequant_matmul", 0) + 1
    want = (x.float() @ dequantize_weight(q).float()).to(x.dtype)
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("bits", [4, 8])
def test_w4a8_kernel(dev, rows, bits):
    q = _qlin(dev, 1024, 384, bits, torch.bfloat16)
    x = _x(dev, rows, 1024)
    _close(qm.quant_matmul(x, q, variant="w4a8"), qm.qmm_w4a8_plain(x, q))


def test_padded_columns_sliced(dev):
    q = _qlin(dev, 512, 300, 4, torch.bfloat16, pad_out=128)
    x = _x(dev, 2, 512)
    got = qm.quant_matmul(x, q)
    assert got.shape == (2, 300)
    _close(got, qm.qmm_group_plain(x, q)[:, :300])


@pytest.mark.parametrize("rep", [1, 3, 4])
def test_flash_decode_q8_kernel(dev, rep):
    g = torch.Generator(device=dev).manual_seed(rep)
    B, Hkv, S, D = 4, 2, 256, 128
    q = torch.randn(B, Hkv * rep, 1, D, generator=g, device=dev).to(
        torch.bfloat16)
    kc = torch.randint(-127, 128, (B, Hkv, S, D), generator=g, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, Hkv, S, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(B, Hkv, S, generator=g, device=dev) * 0.015 + 0.005
    vs = torch.rand(B, Hkv, S, generator=g, device=dev) * 0.015 + 0.005
    pos = torch.tensor([0, 63, 64, 255], dtype=torch.int32, device=dev)
    args = (q, kc, vc, ks, vs, pos)
    _close(att.flash_decode_q8(*args), att.flash_decode_q8_plain(*args))


@pytest.mark.parametrize("S", [1, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(dev, S, causal):
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(2, 3, S, 128, generator=g, device=dev).mul(2)
               .to(torch.bfloat16) for _ in range(3))
    _close(fa.flash_attention(q, k, v, causal), fa.mha_plain(q, k, v, causal))


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_decode_kernel(dev, rep):
    g = torch.Generator(device=dev).manual_seed(10 + rep)
    B, Hkv, S, D = 4, 2, 300, 128
    q = torch.randn(B, Hkv * rep, 1, D, generator=g, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn(B, Hkv, S, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.tensor([0, 100, 256, 299], dtype=torch.int32, device=dev)
    args = (q, kc, vc, pos)
    _close(att.flash_decode(*args), att.flash_decode_plain(*args))
    # rows past pos are never read: garbage there changes nothing
    kc[1, :, 101:] = float("nan")
    vc[1, :, 101:] = float("nan")
    _close(att.flash_decode(*args)[1], att.flash_decode_plain(
        q[1:2], kc[1:2, :, :101], vc[1:2, :, :101], pos[1:2])[0])


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    """What no kernel takes raises (a head dim that is no multiple of 8,
    or above 256; an int or f64 x); what the fast kernels do not take
    (decode at D 32, an f32 q over a 16-bit cache) launches the any-type
    form, and
    the prefill at D 48 the tensor-core kernel (zero-padded to 64), never
    the plain version. An f32 q over an f32 cache at D 64 or 128 takes the
    fast kernel (test_flash_decode_f32_fast_forms); over a bf16 cache the
    any-type form."""
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    for D in (12, 272):
        q = torch.zeros(1, 2, 1, D, dtype=torch.bfloat16, device=dev)
        kc = torch.zeros(1, 2, 16, D, dtype=torch.int8, device=dev)
        s = torch.zeros(1, 2, 16, device=dev)
        with pytest.raises(ValueError, match="multiple of 8"):
            att.flash_decode_q8(q, kc, kc, s, s, pos)
        with pytest.raises(ValueError, match="multiple of 8"):
            att.flash_decode(q, kc.bfloat16(), kc.bfloat16(), pos)
        with pytest.raises(ValueError, match="multiple of 8"):
            fa.flash_attention(kc.bfloat16(), kc.bfloat16(), kc.bfloat16())
    qq = _qlin(dev, 512, 256, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="floating point"):
        qm.quant_matmul(torch.ones(1, 512, dtype=torch.int32, device=dev),
                        qq)                             # int32 x
    with pytest.raises(NotImplementedError, match="bf16, f16 and f32"):
        qm.quant_matmul(_x(dev, 1, 512).double(), qq)   # f64 x
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(1, 2, 1, 32, generator=g, device=dev).bfloat16()
    kb = torch.randn(1, 2, 16, 32, generator=g, device=dev).bfloat16()
    before = dict(att.launches)
    _close(att.flash_decode(q, kb, kb, pos),
           att.flash_decode_plain(q, kb, kb, pos))        # D = 32
    x48 = torch.randn(1, 2, 8, 48, generator=g, device=dev).bfloat16()
    _close(fa.flash_attention(x48, x48, x48),
           fa.mha_plain(x48, x48, x48))                   # D = 48
    x32 = torch.randn(1, 2, 8, 128, generator=g, device=dev)
    _close(fa.flash_attention(x32, x32, x32),
           fa.mha_plain(x32, x32, x32))                   # f32
    kb16 = x32.bfloat16()
    _close(att.flash_decode(x32[:, :, :1].contiguous(), kb16, kb16, pos),
           att.flash_decode_plain(x32[:, :, :1], kb16, kb16, pos))
    assert att.launches["flash_decode_any"] == \
        before.get("flash_decode_any", 0) + 2       # f32 q, bf16 cache


def _ragged_pos(dev, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randint(0, S, (B,), generator=g)
    pos[0], pos[-1] = 0, S - 1
    return pos.to(torch.int32).to(dev)


@pytest.mark.parametrize("rep,B,S", [(1, 64, 384), (1, 3, 300), (4, 5, 520)])
def test_flash_decode_kernels_at_head_dim_64(dev, rep, B, S):
    """GPT-2's head dim: both cache types, ragged pos, rows past pos NaN
    (bf16 cache) or NaN-scaled (INT8 cache)."""
    g = torch.Generator(device=dev).manual_seed(B + S)
    Hkv, D = 2 if rep > 1 else 16, 64
    q = torch.randn(B, Hkv * rep, 1, D, generator=g, device=dev).to(
        torch.bfloat16)
    pos = _ragged_pos(dev, B, S, S)
    dead = (torch.arange(S, device=dev)[None] > pos[:, None])[:, None] \
        .expand(B, Hkv, S)
    kc, vc = (torch.randn(B, Hkv, S, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    want = att.flash_decode_plain(q, kc, vc, pos)
    kc[dead] = float("nan")
    vc[dead] = float("nan")
    before = att.launches["flash_decode"]
    got = att.flash_decode(q, kc, vc, pos)
    assert att.launches["flash_decode"] == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, want)
    kq, vq = (torch.randint(-127, 128, (B, Hkv, S, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, Hkv, S, generator=g, device=dev) * 0.015 + 0.005
              for _ in range(2))
    want = att.flash_decode_q8_plain(q, kq, vq, ks, vs, pos)
    ks[dead] = float("nan")
    vs[dead] = float("nan")
    got = att.flash_decode_q8(q, kq, vq, ks, vs, pos)
    assert torch.isfinite(got.float()).all()
    _close(got, want)


def _ln_inputs(dev, din, seed=3):
    g = torch.Generator().manual_seed(seed)
    gamma = (torch.rand(din, generator=g) + 0.5).to(torch.bfloat16).to(dev)
    beta = (torch.randn(din, generator=g) * 0.1).to(torch.bfloat16).to(dev)
    return gamma, beta


@pytest.mark.parametrize("rows", [1, 3, 64, 256])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bias_dt", [None, torch.bfloat16, torch.float32])
def test_group_ln_kernel(dev, rows, bits, bias_dt):
    q = _qlin(dev, 1024, 300, bits, torch.float32, pad_out=128)
    assert q.out_physical == 384 and q.out_features == 300
    x = _x(dev, rows, 1024) * 3 + 0.5
    gamma, beta = _ln_inputs(dev, 1024)
    bias = None if bias_dt is None else \
        _x(dev, 1, 300, seed=5)[0].to(bias_dt)
    before = qm.launches["qmm_group_ln"]
    got = qm.quant_matmul_ln(x, gamma, beta, q, bias=bias, eps=1e-5)
    assert qm.launches["qmm_group_ln"] == before + 1
    assert got.shape == (rows, 300)
    _close(got, qm.qmm_group_ln_plain(x, gamma, beta, q, bias, 1e-5)[:, :300])


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bias_dt", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm_dt", [torch.bfloat16, torch.float32])
def test_group_ln_kernel_k_split(dev, splits, bits, bias_dt, norm_dt,
                                 monkeypatch):
    """qmm_group_ln at one row in its K split (quant_matmul.cuh KSPLIT with
    the LayerNorm prologue), the split count forced through _SPLITS (1:
    the unsplit form), against qmm_group_ln_plain: int8 and unpaired int4,
    gamma / beta in bf16 and f32, a bias in bf16, f32 or none, padded
    columns. Unforced, GPT-2's w_qkv shape takes the split (8 on the
    H100's 132 SMs)."""
    din = 1024 if bits == 8 else 2048          # 8 scale groups of K or more
    q = _qlin(dev, din, 300, bits, torch.float32, pad_out=128)
    x = _x(dev, 1, din) * 3 + 0.5
    gamma, beta = (t.to(norm_dt) for t in _ln_inputs(dev, din))
    bias = None if bias_dt is None else \
        _x(dev, 1, 300, seed=5)[0].to(bias_dt)
    monkeypatch.setattr(qm, "_SPLITS", splits)
    before = dict(qm.launches)
    got = qm.quant_matmul_ln(x, gamma, beta, q, bias=bias, eps=1e-5)
    torch.cuda.synchronize()
    assert qm.launches["qmm_group_ln"] == before.get("qmm_group_ln", 0) + 1
    assert qm.launches["qmm_group_ln_split"] == \
        before.get("qmm_group_ln_split", 0) + (splits > 1)
    assert qm.launches["qmm_group_ln_mma"] == before.get("qmm_group_ln_mma", 0)
    want = qm.qmm_group_ln_plain(x, gamma, beta, q, bias, 1e-5)[:, :300]
    _close(got, want)
    # the counters are zero again: a second launch gives the same bits
    again = qm.quant_matmul_ln(x, gamma, beta, q, bias=bias, eps=1e-5)
    assert torch.equal(got, again)
    monkeypatch.setattr(qm, "_SPLITS", None)
    q3 = _qlin(dev, 1024, 3072, 8, torch.float32)
    n = qm.launches["qmm_group_ln_split"]
    qm.quant_matmul_ln(_x(dev, 1, 1024), gamma[:1024], beta[:1024], q3)
    assert qm.launches["qmm_group_ln_split"] == n + (
        qm.group_splits(1, 3072, 1024, 128, _build.sms(0)) > 1)


def test_group_ln_composition_on_the_card(dev):
    """What the fused kernel does not take runs LayerNorm + a matmul kernel
    (qmm_group, qmm_slab, qmm_chunk; above 256 rows the dequant route) +
    bias on the card, an f32 x included (the kernels' f32 x load): never a
    plain version."""
    gamma, beta = _ln_inputs(dev, 1024)
    q = _qlin(dev, 1024, 256, 8, torch.float32)
    bias = _x(dev, 1, 256, seed=5)[0]
    x = _x(dev, 300, 1024)
    before = dict(qm.launches)
    got = qm.quant_matmul_ln(x, gamma, beta, q, bias=bias)
    assert qm.launches["dequant_matmul"] == \
        before.get("dequant_matmul", 0) + 1
    xn = qm.layer_norm(x, gamma, beta, 1e-5)
    want = (xn.float() @ dequantize_weight(q).float()).to(x.dtype) + bias
    _close(got, want)
    # f32 gamma and beta (one of them is enough) are read by the kernel
    for gm, bt in ((gamma.float(), beta.float()), (gamma.float(), beta)):
        n = qm.launches["qmm_group_ln"]
        got = qm.quant_matmul_ln(x[:5], gm, bt, q, bias=bias)
        assert qm.launches["qmm_group_ln"] == n + 1
        _close(got, qm.qmm_group_ln_plain(x[:5], gamma, beta, q, bias, 1e-5))
    # a paired weight: LayerNorm + qmm_slab + bias
    qp = _paired(dev, 1024, 256, torch.float32)
    n = qm.launches["qmm_slab"]
    got = qm.quant_matmul_ln(x[:5], gamma, beta, qp, bias=bias)
    assert qm.launches["qmm_slab"] == n + 1
    _close(got, qm.qmm_slab_plain(xn[:5], qp) + bias)
    # a group of 64: LayerNorm + qmm_chunk + bias; an f32 x: LayerNorm in
    # f32 + qmm_group on the f32 x + bias, in f32
    q64 = _qlin(dev, 1024, 256, 8, torch.float32, group=64)
    n = qm.launches["qmm_chunk"]
    got = qm.quant_matmul_ln(x[:5], gamma, beta, q64, bias=bias)
    assert qm.launches["qmm_chunk"] == n + 1
    _close(got, qm.qmm_chunk_plain(xn[:5], q64) + bias)
    n = qm.launches["qmm_group"]
    x32 = x[:5].float()
    got = qm.quant_matmul_ln(x32, gamma, beta, q, bias=bias)
    assert qm.launches["qmm_group"] == n + 1 and got.dtype == torch.float32
    _close(got, qm.qmm_group_plain(qm.layer_norm(x32, gamma, beta, 1e-5),
                                   q)[:, :256] + bias)


def _paired(dev, din, dout, sdt, pad_out=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = quantize_weight(torch.randn(din, dout, generator=g), bits=4,
                        group_size=128, pad_out=pad_out, paired=True)
    assert q.paired and q.scales.shape[0] == din // 256
    return QuantizedLinear(q.qweight.to(dev), q.scales.to(sdt).to(dev), 4,
                           q.group_size, q.out_logical)


@pytest.mark.parametrize("rows", [1, 3, 64, 256])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_slab_kernels(dev, rows, sdt):
    q = _paired(dev, 1024, 300, sdt, pad_out=128)
    x = _x(dev, rows, 1024)
    before = dict(qm.launches)
    # paired overrides whatever variant was asked for
    got = qm.quant_matmul(x, q, variant="w4a8")
    assert qm.launches["qmm_slab"] == before.get("qmm_slab", 0) + 1
    assert got.shape == (rows, 300)
    _close(got, qm.qmm_slab_plain(x, q)[:, :300])
    nw = (torch.rand(1024, generator=torch.Generator().manual_seed(2))
          + 0.5).to(torch.bfloat16).to(dev)
    got = qm.quant_matmul_norm(x * 4, nw, q)
    assert qm.launches["qmm_slab_norm"] == \
        before.get("qmm_slab_norm", 0) + 1
    assert qm.launches["qmm_group"] == before.get("qmm_group", 0)
    _close(got, qm.qmm_slab_plain(qm.rmsnorm_bf16(x * 4, nw, 1e-5), q)[
        :, :300])
    # an odd number of scale rows (din = 768: 3 packed groups)
    q3 = _paired(dev, 768, 256, sdt, seed=4)
    x3 = _x(dev, rows, 768)
    _close(qm.quant_matmul(x3, q3), qm.qmm_slab_plain(x3, q3))


def test_slab_on_unpaired_weight_is_group(dev):
    q = _qlin(dev, 1024, 256, 4, torch.bfloat16)
    x = _x(dev, 2, 1024)
    before = qm.launches["qmm_group"]
    _close(qm.quant_matmul(x, q, variant="slab"), qm.qmm_group_plain(x, q))
    assert qm.launches["qmm_group"] == before + 1


def _small_model(dev):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, intermediate=1024, max_seq=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.quantize_llama_params(
        llama.init_llama_params(cfg, gen, device=dev), bits=4,
        group_size=128)
    return cfg, params


@pytest.mark.parametrize("kv_quant", [True, False])
def test_decode_graph_equals_eager(dev, kv_quant):
    cfg, params = _small_model(dev)
    tok0 = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    pos0 = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    toks, last, pos, _ = llama.llama_decode_multi(
        params, cfg, tok0, pos0,
        llama.init_kv_cache(cfg, 2, kv_quant=kv_quant, device=dev), 6)
    cache = llama.init_kv_cache(cfg, 2, kv_quant=kv_quant, device=dev)
    tok, p, want = tok0, pos0, []
    for _ in range(6):
        logits, cache = llama.llama_decode_step(params, cfg, tok, p, cache)
        assert torch.isfinite(logits.float()).all()
        tok = torch.argmax(logits, -1).to(torch.int32)
        want.append(tok)
        p = p + 1
    np.testing.assert_array_equal(toks.cpu().numpy(),
                                  torch.stack(want, 1).cpu().numpy())
    assert torch.equal(pos, pos0 + 6) and torch.equal(last, tok)


def test_greedy_generate_graph_equals_eager(dev):
    """bf16 cache (the default): greedy_generate's CUDA-graph decode gives
    the tokens of prefill + an eager decode loop."""
    cfg, params = _small_model(dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1),
                           dtype=torch.int32)
    launches = fa.launches["flash_attention"], att.launches["flash_decode"]
    toks, cache = llama.greedy_generate(params, cfg, prompt, 6)
    assert toks.shape == (2, 6) and cache["k"][0].dtype == torch.bfloat16
    assert fa.launches["flash_attention"] > launches[0]
    assert att.launches["flash_decode"] > launches[1]
    cache = llama.init_kv_cache(cfg, 2, device=dev)
    logits, cache = llama.llama_prefill(params, cfg, prompt, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    p, want = torch.full((2,), 40, dtype=torch.int32, device=dev), [tok]
    for _ in range(5):
        logits, cache = llama.llama_decode_step(params, cfg, tok, p, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        want.append(tok)
        p = p + 1
    np.testing.assert_array_equal(toks.cpu().numpy(),
                                  torch.stack(want, 1).cpu().numpy())


def _paged_case(dev, rep, P, q8, seed, B=5, D=128, qdt=torch.bfloat16):
    """A shuffled block table over a pool with spare pages; pos ragged,
    with 0 and both sides of a page boundary (B slots, at most 8); q in
    qdt, float pages in qdt. Every page that no live row of a slot lies
    in, and every row past pos of a slot's last live page, holds NaN (in
    the scales for int8 pages)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv, MP = 2, 6
    N = B * MP + 3
    pos = torch.tensor([0, P - 1, P, 3 * P + 5, MP * P - 1, 100, 5,
                        2 * P + 1][:B], dtype=torch.int32, device=dev)
    table = torch.randperm(N - 1, generator=g, device=dev)[:B * MP].add(1) \
        .reshape(B, MP).to(torch.int32)
    q = torch.randn(B, Hkv * rep, 1, D, generator=g, device=dev).to(qdt)
    live = torch.zeros(N, P, dtype=torch.bool, device=dev)
    for b in range(B):
        for s in range(int(pos[b]) + 1):
            live[table[b, s // P], s % P] = True
    dead = ~live[:, None, :].expand(N, Hkv, P)
    if q8:
        kp, vp = (torch.randint(-127, 128, (N, Hkv, P, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(N, Hkv, P, generator=g, device=dev) * 0.015
                  + 0.005 for _ in range(2))
        ks[dead] = float("nan")
        vs[dead] = float("nan")
        return (q, kp, vp, ks, vs, table, pos)
    kp, vp = (torch.randn(N, Hkv, P, D, generator=g, device=dev).to(qdt)
              for _ in range(2))
    kp[dead] = float("nan")
    vp[dead] = float("nan")
    return (q, kp, vp, table, pos)


@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_paged_flash_decode_kernel(dev, rep, P):
    args = _paged_case(dev, rep, P, False, 100 + rep + P)
    before = pa.launches["paged_flash_decode"]
    got = pa.paged_flash_decode(*args)
    assert pa.launches["paged_flash_decode"] == before + 1
    assert torch.isfinite(got.float()).all()    # no dead row was read
    _close(got, pa.paged_decode_plain(*args))


@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_paged_flash_decode_q8_kernel(dev, rep, P):
    args = _paged_case(dev, rep, P, True, 200 + rep + P)
    before = pa.launches["paged_flash_decode_q8"]
    got = pa.paged_flash_decode_q8(*args)
    assert pa.launches["paged_flash_decode_q8"] == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, pa.paged_decode_q8_plain(*args))


def test_paged_wrappers_raise_instead_of_falling_back(dev):
    """What no paged kernel takes raises (an int64 table, bf16 pages for
    the INT8 kernel, a head dim that is no multiple of 8 or above 256);
    head dim 64 and f32 pages, refused before the any-type form, launch."""
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 2, 1, 128, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(4, 2, 16, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        pa.paged_flash_decode(q, kp, kp, table.long(), pos)     # int64 table
    s = torch.zeros(4, 2, 16, device=dev)
    with pytest.raises(ValueError):
        pa.paged_flash_decode_q8(q, kp, kp, s, s, table, pos)   # bf16 pages
    for D in (12, 272):
        qd = torch.zeros(1, 2, 1, D, dtype=torch.bfloat16, device=dev)
        kd = torch.zeros(4, 2, 16, D, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="multiple of 8"):
            pa.paged_flash_decode(qd, kd, kd, table, pos)
    g = torch.Generator(device=dev).manual_seed(5)
    for D, pdt in ((64, torch.bfloat16), (128, torch.float32)):
        qd = torch.randn(1, 2, 1, D, generator=g, device=dev).bfloat16()
        kd = torch.randn(4, 2, 16, D, generator=g, device=dev).to(pdt)
        _close(pa.paged_flash_decode(qd, kd, kd, table, pos),
               pa.paged_decode_plain(qd, kd, kd, table, pos))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_engine_under_graph_equals_dense_and_eager(dev, kv_quant):
    """A tiny engine on the card: the paged engine's captured decode step
    gives the tokens of the same engine run eagerly and of the dense
    engine, with a pool that makes admission wait for reclaim."""
    cfg, params = _small_model(dev)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(4, 40, 9), rng.integers(5, 20, 9))]

    def drain(eng, eager=False):
        eng.use_cuda_graph = not eager
        rs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        eng.run_to_completion()
        assert (eng._program.graph is None) == eager
        assert all(r.done for r in rs)
        return [list(r.generated) for r in rs]

    kw = dict(max_slots=4, prefill_buckets=(16, 48), decode_chunk=4,
              kv_quant=kv_quant)
    paged_kw = dict(kw, n_pages=13, page_size=16)
    kname = "paged_flash_decode_q8" if kv_quant else "paged_flash_decode"
    before = pa.launches[kname]
    eng = PagedServingEngine(params, cfg, **paged_kw)
    got = drain(eng)
    # warm-up + capture: n_layers launches each, replays launch nothing new
    assert pa.launches[kname] == before + 2 * cfg.n_layers
    assert eng.free_pages == 12
    assert got == drain(PagedServingEngine(params, cfg, **paged_kw), True)
    assert got == drain(ServingEngine(params, cfg, **kw))


# -- qmm_chunk, qmm_group2d, qmm_norm_w4a8 and the routes to them ----------

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


@pytest.mark.parametrize("rows", [1, 3, 8, 256])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_chunk_kernel(dev, bits, group, rows):
    q = _qlin(dev, 1024, 260, bits, torch.float32, group=group)
    x = _x(dev, rows, 1024)
    before = qm.launches["qmm_chunk"]
    got = qm.quant_matmul(x, q, variant="chunk")
    assert qm.launches["qmm_chunk"] == before + 1
    _close(got, qm.qmm_chunk_plain(x, q))


def test_chunk_kernel_at_an_odd_group_count_per_warp(dev):
    """w_down's split at group 64 (86 groups on 16 warps), bf16 scales;
    at 8 rows the tensor-core form (86 splits of one group) and the
    CUDA-core form, forced."""
    q = _qlin(dev, 11008, 256, 4, torch.bfloat16, group=64)
    assert q.scales.shape[0] == 172
    for rows in (1, 8):
        x = _x(dev, rows, 11008)
        _close(qm.quant_matmul(x, q), qm.qmm_chunk_plain(x, q))
        _close(qm._launch_chunk(x, q, form="cuda_core"),
               qm.qmm_chunk_plain(x, q))


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("kb", [128, 256, 512])
@pytest.mark.parametrize("bits", [4, 8])
def test_group2d_kernel(dev, bits, kb, rows, knobs):
    q = _qlin(dev, 2048, 384, bits, torch.bfloat16)
    knobs(table={f"2048:384:{bits}": {"variant": "group2d", "bn": 128,
                                      "kb": kb}})
    x = _x(dev, rows, 2048)
    assert qm.route(x, q) == ("qmm_group2d", kb)
    before = qm.launches["qmm_group2d"]
    got = qm.quant_matmul(x, q)
    assert qm.launches["qmm_group2d"] == before + 1
    _close(got, qm.qmm_group2d_plain(x, q, kb))
    assert torch.equal(qm.quant_matmul(x, q), got)     # no atomics
    _close(got, qm.qmm_group_plain(x, q))


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_norm_w4a8_kernel(dev, bits, rows, knobs):
    q = _qlin(dev, 4096, 384, bits, torch.bfloat16)
    x = _x(dev, rows, 4096) * 4
    nw = (torch.rand(4096, generator=torch.Generator().manual_seed(2))
          + 0.5).to(torch.bfloat16).to(dev)
    knobs(variant="w4a8")
    before = dict(qm.launches)
    got = qm.quant_matmul_norm(x, nw, q)
    assert qm.launches["qmm_norm_w4a8"] == \
        before.get("qmm_norm_w4a8", 0) + 1
    assert qm.launches["qmm_group_norm"] == before.get("qmm_group_norm", 0)
    _close(got, qm.qmm_norm_w4a8_plain(x, nw, q, 1e-5))


def _decode_launches(params, cfg, dev):
    counters = (qm.launches, att.launches)
    for c in counters:
        c.clear()
    tok = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    logits, _ = llama.llama_decode_step(
        params, cfg, tok, pos,
        llama.init_kv_cache(cfg, 2, kv_quant=True, device=dev))
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    out = {}
    for c in counters:
        out.update(c)
    return out


def test_decode_routes_launch_counts(dev, knobs):
    """One decode step of a small model through each route: group 64
    (entry()), W4A8 under the env var with an empty table, split-K from
    a table entry for wo and w_down (the lm_head, 512 -> 512 here, shares
    wo's key)."""
    from infinitensor_tpu_torch.entry import entry
    fn, (params, cfg, token, pos, cache) = entry()
    L = cfg.n_layers
    qm.launches.clear()
    att.launches.clear()
    fn(params, cfg, token, pos, cache)
    torch.cuda.synchronize()
    lay = params["layers"][0]
    split = sum(qm.group_splits(token.shape[0], q.out_physical,
                                q.qweight.shape[0], q.group_size,
                                _build.sms(0)) > 1
                for q in (lay["wqkv"], lay["wo"], lay["w_gateup"]))
    split = L * split + (qm.group_splits(
        token.shape[0], params["lm_head"].out_physical,
        params["lm_head"].qweight.shape[0], params["lm_head"].group_size,
        _build.sms(0)) > 1)
    # two rows: qmm_chunk's tensor-core form from CHUNK_MMA_MIN_ROWS, else
    # its CUDA-core form, in the K split on these short grids
    if qm.chunk_form(token.shape[0], torch.bfloat16, 64) == "mma":
        chunk = {"qmm_chunk_mma": 3 * L + 1}
    else:
        assert split > 0
        chunk = {"qmm_chunk_split": split}
    assert {**qm.launches, **att.launches} == {
        "qmm_chunk": 3 * L + 1, **chunk,
        "dequant_matmul": L, "flash_decode_q8": L,
        **att.merge_launches(L, 1, cfg.n_kv_heads, cfg.max_seq)}
    cfg, params = _small_model(dev)
    L = cfg.n_layers
    merges = att.merge_launches(L, 2, cfg.n_kv_heads, cfg.max_seq)
    knobs(variant="w4a8")
    # two tokens: wo, w_down and the lm_head take qmm_w4a8's tensor-core
    # form from W4A8_MMA_MIN_ROWS rows, and the fused-norm launches
    # qmm_norm_w4a8's
    mma = {"qmm_w4a8_mma": 2 * L + 1, "qmm_norm_w4a8_mma": 2 * L} \
        if 2 >= qm.W4A8_MMA_MIN_ROWS else {}
    assert _decode_launches(params, cfg, dev) == {
        "qmm_norm_w4a8": 2 * L, "qmm_w4a8": 2 * L + 1, "flash_decode_q8": L,
        **mma, **merges}
    knobs(table={"512:512:4": {"variant": "group2d", "bn": 128, "kb": 128},
                 "1024:512:4": {"variant": "group2d", "bn": 128, "kb": 256}})
    # two tokens: the fused-norm launches take qmm_group_norm's
    # tensor-core form from MMA_MIN_ROWS rows
    mma = {"qmm_group_norm_mma": 2 * L} if 2 >= qm.MMA_MIN_ROWS else {}
    assert _decode_launches(params, cfg, dev) == {
        "qmm_group_norm": 2 * L, "qmm_group2d": 2 * L + 1,
        "flash_decode_q8": L, **mma, **merges}


# -- the graph slice: rmsnorm, the band kernels, flash_attention at D 64, --
# -- f32 activations, and the executor's capture LRU -----------------------

def _rmsnorm_close(got, want):
    """Within 1e-2 of max|plain| in bf16 (a bf16 ulp: the f32 sums are
    taken in another order), 1e-5 in f32."""
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if want.dtype == torch.float32 else TOL
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("rows", [1, 8, 13, 64, 1024, 4097])
@pytest.mark.parametrize("d", [4096, 4104, 520, 1001])
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel(dev, rows, d, xdt, wdt):
    """rmsnorm against rmsnorm_plain, bit for bit across two launches,
    counted once a launch: widths whose rows the kernel holds in registers
    (4096 in bf16), reads past them again (4104, f32), fits in one pass
    (520) or walks with scalar loads (1001, no multiple of a 16-byte
    chunk)."""
    from infinitensor_tpu_torch.kernels import norms
    g = torch.Generator().manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g) * 3).to(xdt).to(dev)
    w = (torch.rand(d, generator=g) + 0.5).to(wdt).to(dev)
    want = norms.rmsnorm_plain(x, w, 1e-5)
    before = norms.launches["rmsnorm"]
    got = norms.rmsnorm(x, w, 1e-5)
    assert norms.launches["rmsnorm"] == before + 1
    _rmsnorm_close(got, want)
    assert torch.equal(got, norms.rmsnorm(x, w, 1e-5))


@pytest.mark.parametrize("rows", [1, 13, 1024])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_misaligned_view(dev, rows, xdt):
    """An x that is a contiguous view 2 (bf16) or 4 (f32) bytes past a
    16-byte boundary: the kernel takes its scalar loads and agrees with
    rmsnorm_plain, bit for bit across two launches."""
    from infinitensor_tpu_torch.kernels import norms
    g = torch.Generator().manual_seed(rows)
    d = 4096
    buf = (torch.randn(rows * d + 1, generator=g) * 3).to(xdt).to(dev)
    x = buf[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = (torch.rand(d, generator=g) + 0.5).to(torch.bfloat16).to(dev)
    got = norms.rmsnorm(x, w, 1e-5)
    _rmsnorm_close(got, norms.rmsnorm_plain(x, w, 1e-5))
    assert torch.equal(got, norms.rmsnorm(x, w, 1e-5))


_BAND_W = (0, 1, 7, 64, 130, 256)
_BAND_M = (1, 17, 63, 64, 65, 300, 2048)
_BAND_K = (8, 24, 64, 96, 128, 256)
# every w and m (m < w included), each k and bz 1-12 in turn; then the
# shapes the first form was tested at
_BAND_SHAPES = [(1 + (7 * i + j) % 12, m, _BAND_K[(i + j) % 6], w)
                for i, w in enumerate(_BAND_W)
                for j, m in enumerate(_BAND_M)] + [
    (2, 64, 128, 6), (3, 100, 64, 20), (1, 300, 32, 130), (8, 2048, 128, 64)]


def _band_inputs(dev, dtype, bz, m, k, w):
    g = torch.Generator().manual_seed(m * 1000 + k + w)
    a = torch.randn(bz, m, k, generator=g).to(dtype).to(dev)
    b = torch.randn(bz, m, k, generator=g).to(dtype).to(dev)
    wts = torch.softmax(torch.randn(bz, m, 2 * w + 1, generator=g),
                        -1).to(dtype).to(dev)
    return a, b, wts


def _band_close(got, want):
    """Within 1e-2 of max|plain| in bf16, 1e-5 in f32 (f32 sums taken in
    another order)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if want.dtype == torch.float32 else TOL
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _band_old_form_fits(dtype, k, w):
    """Whether csrc/band.cu (which stages the whole window) takes (k, w):
    its smallest block, one row, within 232,448 bytes of shared memory."""
    el = torch.empty(0, dtype=dtype).element_size()
    ld = (k | 1) if el == 4 else ((k + (k & 1)) if (k + (k & 1)) % 4 == 2
                                  else k + (k & 1) + 2)
    g2 = ld * el + 16 + (1 + 2 * w) * ld * el
    g = (2 * w + 1) * el + 16 + (1 + 2 * w) * k * el
    return max(g2, g) <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bz,m,k,w", _BAND_SHAPES)
def test_band_kernels(dev, dtype, bz, m, k, w):
    """g2bmm / gbmm in their ring form (the route's: both operands bf16 or
    both f32, k a multiple of 8 up to 256) against the plain versions,
    counted under <op> and <op>_ring, equal bits across two calls; the
    old form forced (csrc/band.cu) where its window fits."""
    from infinitensor_tpu_torch.kernels import band
    a, b, wts = _band_inputs(dev, dtype, bz, m, k, w)
    assert band.band_form(dtype, dtype, k) == "ring"
    before = dict(band.launches)
    s = band.g2bmm_band(a, b, w)
    o = band.gbmm_band(wts, b, w)
    _band_close(s, band.g2bmm_plain(a, b, w))
    _band_close(o, band.gbmm_plain(wts, b, w))
    for name in ("g2bmm", "g2bmm_ring", "gbmm", "gbmm_ring"):
        assert band.launches[name] == before.get(name, 0) + 1, name
    assert torch.equal(s, band.g2bmm_band(a, b, w))
    assert torch.equal(o, band.gbmm_band(wts, b, w))
    if _band_old_form_fits(dtype, k, w):
        _band_close(band.g2bmm_band(a, b, w, form="simt"),
                    band.g2bmm_plain(a, b, w))
        _band_close(band.gbmm_band(wts, b, w, form="simt"),
                    band.gbmm_plain(wts, b, w))
    with pytest.raises(ValueError, match="dilation"):
        band.g2bmm_band(a, b, w, d=2)


@pytest.mark.parametrize("case", ["mixed", "k20"])
def test_band_old_form_route(dev, case):
    """A mixed bf16 / f32 pair and k = 20 take the old form (csrc/band.cu):
    counted under g2bmm / gbmm and not under <op>_ring; forcing the ring
    form on them raises."""
    from infinitensor_tpu_torch.kernels import band
    k = 20 if case == "k20" else 64
    a, b, wts = _band_inputs(dev, torch.bfloat16, 2, 130, k, 9)
    if case == "mixed":
        a, wts = a.float(), wts.float()
    assert band.band_form(a.dtype, b.dtype, k) == "simt"
    before = dict(band.launches)
    got_s, got_o = band.g2bmm_band(a, b, 9), band.gbmm_band(wts, b, 9)
    _band_close(got_s, band.g2bmm_plain(a, b, 9))
    _band_close(got_o, band.gbmm_plain(wts, b, 9))
    for name, n in (("g2bmm", 1), ("gbmm", 1), ("g2bmm_ring", 0),
                    ("gbmm_ring", 0)):
        assert band.launches[name] == before.get(name, 0) + n, name
    with pytest.raises(ValueError, match="no form 'ring'"):
        band.g2bmm_band(a, b, 9, form="ring")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_ring_in_a_cuda_graph(dev, dtype):
    """The ring forms captured in a CUDA graph give the eager bits, at the
    phase 13 shape and at a wide band whose tile is not staged."""
    from infinitensor_tpu_torch.kernels import band
    for bz, m, k, w in ((8, 2048, 128, 64), (1, 300, 64, 1000)):
        a, b, wts = _band_inputs(dev, dtype, bz, m, k, w)
        want = (band.g2bmm_band(a, b, w), band.gbmm_band(wts, b, w))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            band.g2bmm_band(a, b, w), band.gbmm_band(wts, b, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = (band.g2bmm_band(a, b, w), band.gbmm_band(wts, b, w))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_band_ring_unaligned_views(dev):
    """Operands that start 2 bytes past a 16-byte boundary (views into a
    larger buffer): the ring form takes aligned copies of A and B and
    reads W and writes out at any offset, as the plain versions say."""
    from infinitensor_tpu_torch.kernels import band
    g = torch.Generator().manual_seed(5)
    bz, m, k, w = 3, 77, 64, 9
    buf = torch.randn(1 + 3 * bz * m * k + bz * m * (2 * w + 1),
                      generator=g).to(torch.bfloat16).to(dev)
    a = buf[1:1 + bz * m * k].view(bz, m, k)
    b = buf[1 + bz * m * k:1 + 2 * bz * m * k].view(bz, m, k)
    wts = buf[1 + 2 * bz * m * k:1 + 2 * bz * m * k + bz * m * (2 * w + 1)
              ].view(bz, m, 2 * w + 1)
    assert a.data_ptr() % 16 and wts.data_ptr() % 16
    _band_close(band.g2bmm_band(a, b, w), band.g2bmm_plain(a, b, w))
    _band_close(band.gbmm_band(wts, b, w), band.gbmm_plain(wts, b, w))


@pytest.mark.parametrize("S", [1, 77, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_dim_64(dev, S, causal):
    """ROADMAP Queue 3 item 2: the head dim of the prefill kernel is a
    template parameter, 64 or 128."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(2, 8, S, 64, generator=g).to(torch.bfloat16)
               .to(dev) for _ in range(3))
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.launches["flash_attention"] == before + 1
    _close(got, fa.mha_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("variant,group", [("group", 128), ("w4a8", 128),
                                           ("chunk", 64)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 5])
def test_f32_activations_on_the_card(dev, variant, group, bits, rows):
    """ROADMAP Queue 3 item 1: an f32 x launches the kernel through its
    f32 x load and gets f32 out, held to the plain version on f32."""
    q = _qlin(dev, 1024, 260, bits, torch.float32, group=group)
    x = _x(dev, rows, 1024).float() * 1.7
    name, _ = qm.route(x, q, variant)
    assert name == "qmm_" + variant
    before = qm.launches[name]
    got = qm.quant_matmul(x, q, variant=variant)
    assert qm.launches[name] == before + 1 and got.dtype == torch.float32
    plain = {"group": qm.qmm_group_plain, "w4a8": qm.qmm_w4a8_plain,
             "chunk": qm.qmm_chunk_plain}[variant]
    _close(got, plain(x, q)[:, :260])


def test_f32_activations_split_k_slab_and_norm(dev, knobs):
    q = _qlin(dev, 2048, 384, 4, torch.bfloat16)
    x = _x(dev, 3, 2048).float()
    knobs(table={"2048:384:4": {"variant": "group2d", "bn": 128, "kb": 256}})
    assert qm.route(x, q) == ("qmm_group2d", 256)
    got = qm.quant_matmul(x, q)
    assert got.dtype == torch.float32
    _close(got, qm.qmm_group2d_plain(x, q, 256))
    knobs()
    g = torch.Generator().manual_seed(5)
    qp = quantize_weight(torch.randn(1024, 256, generator=g), bits=4,
                         group_size=128, paired=True)
    qp = QuantizedLinear(qp.qweight.to(dev), qp.scales.to(dev), 4, 128)
    xs = _x(dev, 2, 1024).float()
    assert qm.route(xs, qp)[0] == "qmm_slab"
    _close(qm.quant_matmul(xs, qp), qm.qmm_slab_plain(xs, qp))
    # the fused-norm wrapper runs norm + quant_matmul on an f32 x
    nw = torch.ones(2048, device=dev)
    before = dict(qm.launches)
    out = qm.quant_matmul_norm(x, nw, q)
    assert out.dtype == torch.float32
    assert qm.launches["qmm_group"] == before.get("qmm_group", 0) + 1
    assert qm.launches.get("qmm_group_norm", 0) == \
        before.get("qmm_group_norm", 0)


def test_odd_physical_columns_take_the_dequant_route(dev):
    """ROADMAP Queue 3 item 3: 1002 columns compute on the card."""
    g = torch.Generator().manual_seed(9)
    q = quantize_weight(torch.randn(512, 1002, generator=g), 4, 128)
    q = QuantizedLinear(q.qweight.to(dev), q.scales.to(dev), 4, 128)
    x = _x(dev, 1, 512)
    assert qm.route(x, q) == ("dequant_matmul", 0)
    got = qm.quant_matmul(x, q)
    assert got.shape == (1, 1002)
    _close(got, (x.float() @ dequantize_weight(q).float()).to(x.dtype))


def test_executor_capture_lru(dev):
    """The executor's LRU of captured CUDA graphs: a hit replays the same
    capture, a new signature past the capacity evicts the least recent,
    and a graph mutation clears it."""
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    h = GraphHandler()
    x = h.input((2, 4), name="x")
    h.relu(h.mul(x, h.weight(np.full((4,), 2.0, np.float32))))
    h.graph.infer_output_roles()
    ex = GraphExecutor(h.graph, device=dev, cache_capacity=2)
    a = torch.randn(2, 4, device=dev)
    (out,) = ex.run({"x": a}).values()
    cap = ex._cache[ex._signature({"x": a})]
    assert cap.captured
    torch.testing.assert_close(out, torch.relu(2 * a))
    (out,) = ex.run({"x": -a}).values()                 # a hit: replayed
    assert len(ex._cache) == 1 and next(iter(ex._cache.values())) is cap
    torch.testing.assert_close(out, torch.relu(-2 * a))
    b = torch.randn(2, 4, device=dev, dtype=torch.float64)  # -> f32 as JAX
    ex.run({"x": b})
    assert len(ex._cache) == 1                          # same signature
    h.change_shape(x, (3, 4))
    h.shape_infer()
    (out,) = ex.run({"x": torch.ones(3, 4, device=dev)}).values()
    assert len(ex._cache) == 1 and out.shape == (3, 4)  # cleared
    assert cap not in ex._cache.values()
    h.change_shape(x, (2, 4))
    h.shape_infer()
    sigs = []
    for rows in (2, 3, 4):
        h.change_shape(x, (rows, 4))
        h.shape_infer()
        ex.run({"x": torch.ones(rows, 4, device=dev)})
        sigs.append(ex._signature({"x": torch.ones(rows, 4, device=dev)}))
    assert list(ex._cache) == [sigs[-1]]    # every change_shape clears


def test_executor_lru_eviction_on_the_card(dev, monkeypatch):
    """Eviction among real captures. One graph version has one valid
    input signature (the IR fixes every input's shape and dtype), so the
    test keys the LRU on an input's value instead, to hold three
    captures of one graph: capacity 2 evicts the least recently used, and
    a hit refreshes an entry."""
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    h = GraphHandler()
    x = h.input((2, 4), name="x")
    h.neg(x)
    h.graph.infer_output_roles()
    ex = GraphExecutor(h.graph, device=dev, cache_capacity=2)
    monkeypatch.setattr(ex, "_signature",
                        lambda vals: float(vals["x"][0, 0]))
    feeds = [ex._materialize({"x": torch.full((2, 4), float(v),
                                              device=dev)})
             for v in (1, 2, 3)]
    progs = [ex._compiled(f) for f in feeds]
    assert all(p.captured for p in progs)
    assert list(ex._cache) == [2.0, 3.0]
    assert ex._compiled(feeds[1]) is progs[1]            # a hit
    ex._compiled(ex._materialize({"x": torch.full((2, 4), 9.0,
                                                  device=dev)}))
    assert list(ex._cache) == [2.0, 9.0]                 # 3.0 evicted
    out = progs[1].replay(feeds[0])
    torch.testing.assert_close(out[next(iter(out))], -feeds[0]["x"])


def test_executor_capture_warmup_and_keep(dev):
    """GraphExecutor.capture, the one capture path of the executor, its
    stepper and the fused decode: the warm-up runs once before the
    capture, the tensors in `keep` get their values back after it, and a
    replay copies new inputs into the static buffers."""
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    h = GraphHandler()
    h.neg(h.input((2, 4), name="x"))
    h.graph.infer_output_roles()
    ex = GraphExecutor(h.graph, device=dev)
    state = torch.zeros(2, 4, device=dev)
    calls = []

    def warm(vals):
        calls.append("warmup")
        state.add_(5)

    def fn(vals):
        state.add_(vals["x"])
        return ex.forward(vals)

    a = torch.randn(2, 4, device=dev)
    cap = ex.capture(fn, {"x": a}, warmup=warm, keep=[state])
    torch.cuda.synchronize()
    assert calls == ["warmup"]
    torch.testing.assert_close(state, torch.zeros(2, 4, device=dev))
    out = cap.replay({"x": 2 * a})
    torch.testing.assert_close(out[next(iter(out))], -2 * a)
    torch.testing.assert_close(state, 2 * a)


def test_graph_llama_on_the_card(dev):
    """A small INT4 + INT8-KV Llama through the graph IR on the card: the
    launches of one step, the stepper's first logits against the
    hand-written step, and the fused (captured) steps equal the stepper's
    and an eager executor's tokens."""
    from infinitensor_tpu_torch.kernels import norms
    from infinitensor_tpu_torch.models import graph_llama as tg
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    cfg, params = _small_model(dev)
    L = cfg.n_layers
    dec = tg.build_llama_decoder(params, cfg, kv_quant=True,
                                 external_weights=True)
    eager = GraphExecutor(dec.graph, device=dev, use_cuda_graph=False)
    tg.bind_llama_weights(dec, eager, params)
    for c in (qm.launches, att.launches, norms.launches):
        c.clear()
    step = eager.stepper(dec.state_map())
    out = step({dec.token_name: torch.tensor([3], dtype=torch.int32,
                                             device=dev),
                dec.pos_name: torch.tensor([0], dtype=torch.int32,
                                           device=dev)})
    torch.cuda.synchronize()
    counts = {**qm.launches, **att.launches, **norms.launches}
    assert counts["qmm_group_norm"] == 2 * L
    assert counts["flash_decode_q8"] == L and counts["rmsnorm"] == 1
    assert counts.get("qmm_group", 0) + counts.get("qmm_w4a8", 0) == 2 * L + 1
    want, _ = llama.llama_decode_step(
        params, cfg, torch.tensor([3], dtype=torch.int32, device=dev),
        torch.tensor([0], dtype=torch.int32, device=dev),
        llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev))
    lg = out[dec.logits_name].float()
    assert (lg - want.float()).abs().max() <= \
        5e-2 * want.float().abs().max()
    ref = tg.graph_greedy_decode(dec, 3, 8, 0, executor=eager)
    ex = GraphExecutor(dec.graph, device=dev)
    tg.bind_llama_weights(dec, ex, params)
    captured = tg.graph_greedy_decode(dec, 3, 8, 0, executor=ex)
    np.testing.assert_array_equal(captured, ref)
    fn, weights, state = tg.make_fused_greedy_decode(dec, ex, multi=4)
    t1, state = fn(weights, torch.tensor([3], device=dev),
                   torch.tensor([0], device=dev), state)
    t2, state = fn(weights, t1[:, -1], torch.tensor([4], device=dev), state)
    np.testing.assert_array_equal(torch.cat([t1, t2], 1).cpu().numpy(), ref)


# -- qmm_group's tensor-core form (csrc/quant_matmul_mma.cu) and f16 x -------

@pytest.mark.parametrize("rows", [8, 9, 16, 63, 64, 100, 256])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16])
def test_group_mma_kernel(dev, rows, bits, xdt):
    """The tensor-core form against qmm_group_plain and against the
    CUDA-core form, both forced, for bf16 and f32 scales, groups 128 and
    256, a dout with no multiple of 16 columns (its 4-byte copies) and a
    padded dout."""
    for sdt in (torch.bfloat16, torch.float32):
        for group in (128, 256):
            for din, dout, pad in ((1024, 384, 0), (1024, 260, 0),
                                   (512, 300, 128)):
                q = _qlin(dev, din, dout, bits, sdt, pad_out=pad,
                          group=group)
                x = _x(dev, rows, din, seed=rows).to(xdt)
                got = qm._launch_group(x, None, q, 0.0, "qmm_group",
                                       form="mma")
                _close(got, qm.qmm_group_plain(x, q))
                _close(got, qm._launch_group(x, None, q, 0.0, "qmm_group",
                                             form="cuda_core"))


def test_group_mma_launch_counts(dev):
    """A 256-row bf16 call launches the tensor-core form, counted under
    qmm_group and qmm_group_mma; a 1-row call the CUDA-core form only."""
    q = _qlin(dev, 2048, 512, 4, torch.bfloat16)
    for rows, mma in ((256, 1), (qm.MMA_MIN_ROWS, 1), (1, 0)):
        before = dict(qm.launches)
        x = _x(dev, rows, 2048)
        _close(qm.quant_matmul(x, q), qm.qmm_group_plain(x, q))
        assert qm.launches["qmm_group"] == before.get("qmm_group", 0) + 1
        assert qm.launches["qmm_group_mma"] == \
            before.get("qmm_group_mma", 0) + mma


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_f16_activations_on_the_card(dev, rows):
    """An f16 x runs on the card and writes f16: qmm_group (either form),
    qmm_chunk, qmm_group2d, qmm_slab; under "w4a8" it launches qmm_group,
    as the JAX package sends it to its group kernel."""
    q = _qlin(dev, 2048, 384, 4, torch.bfloat16)
    x = _x(dev, rows, 2048).half()
    before = dict(qm.launches)
    _close(qm.quant_matmul(x, q, variant="group"), qm.qmm_group_plain(x, q))
    _close(qm.quant_matmul(x, q, variant="w4a8"), qm.qmm_group_plain(x, q))
    assert qm.launches["qmm_group"] == before.get("qmm_group", 0) + 2
    assert qm.launches["qmm_w4a8"] == before.get("qmm_w4a8", 0)
    _close(qm.quant_matmul(x, q, variant="chunk"), qm.qmm_chunk_plain(x, q))
    _close(qm._launch_group2d(x, q, 256), qm.qmm_group2d_plain(x, q, 256))
    qp = quantize_weight(torch.randn(2048, 384, generator=torch.Generator()
                                     .manual_seed(3)), bits=4,
                         group_size=128, paired=True)
    qp = QuantizedLinear(qp.qweight.to(dev), qp.scales.to(dev), 4, 128)
    _close(qm.quant_matmul(x, qp), qm.qmm_slab_plain(x, qp))
    assert qm.launches["qmm_chunk"] == before.get("qmm_chunk", 0) + 1
    assert qm.launches["qmm_group2d"] == before.get("qmm_group2d", 0) + 1
    assert qm.launches["qmm_slab"] == before.get("qmm_slab", 0) + 1


# -- the tensor-core forms of qmm_w4a8 (csrc/quant_matmul_w4a8_mma.cu) and --
# -- qmm_group_ln (csrc/quant_matmul_mma.cu) --------------------------------

@pytest.mark.parametrize("rows", [2, 8, 64, 256])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_w4a8_mma_kernel(dev, rows, bits, xdt, monkeypatch):
    """qmm_w4a8's tensor-core form against qmm_w4a8_plain and against the
    CUDA-core form, both forced: bf16 and f32 scales, groups 128 and 256,
    a dout with no multiple of 16 columns (its 4-byte copies), a padded
    dout, K split (the card's SM count) and not (one SM); and an x view
    that is not 16-byte aligned."""
    sms = _build.sms(0)
    for n_sm in (sms, 1):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        for sdt in (torch.bfloat16, torch.float32):
            for group in (128, 256):
                for din, dout, pad in ((1024, 384, 0), (1024, 260, 0),
                                       (512, 300, 128)):
                    q = _qlin(dev, din, dout, bits, sdt, pad_out=pad,
                              group=group)
                    x = _x(dev, rows, din, seed=rows).to(xdt)
                    got = qm._launch_w4a8(x, q, form="mma")
                    _close(got, qm.qmm_w4a8_plain(x, q))
                    _close(got, qm._launch_w4a8(x, q, form="cuda_core"))
    q = _qlin(dev, 1024, 384, bits, torch.bfloat16)
    buf = torch.empty(rows * 1024 + 8, dtype=xdt, device=dev)
    x = buf[1:1 + rows * 1024].view(rows, 1024)
    x.copy_(_x(dev, rows, 1024, seed=7))
    assert x.data_ptr() % 16
    _close(qm._launch_w4a8(x, q, form="mma"), qm.qmm_w4a8_plain(x, q))


@pytest.mark.parametrize("rows", [2, 8, 64])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bias_dt", [None, torch.bfloat16, torch.float32])
def test_group_ln_mma_kernel(dev, rows, bits, bias_dt, monkeypatch):
    """qmm_group_ln's tensor-core form against qmm_group_ln_plain and
    against the CUDA-core form, both forced, with K split (the card's SM
    count) and not split (one SM), gamma / beta in bf16 and f32, a padded
    dout whose bias covers the logical columns."""
    q = _qlin(dev, 1024, 300, bits, torch.float32, pad_out=128)
    x = _x(dev, rows, 1024) * 3 + 0.5
    gamma, beta = _ln_inputs(dev, 1024)
    bias = None if bias_dt is None else \
        _x(dev, 1, 300, seed=5)[0].to(bias_dt)
    sms = _build.sms(0)
    for n_sm, split in ((sms, True), (1, False)):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        plan = qm.mma_plan(rows, q.out_physical, q.qweight.shape[0],
                           q.group_size, n_sm)
        assert (plan[1] > 1) == split
        want = qm.qmm_group_ln_plain(x, gamma, beta, q, bias, 1e-5)
        for g, b in ((gamma, beta), (gamma.float(), beta.float())):
            got = qm._launch_group_ln(x, g, b, q, bias, 1e-5, form="mma")
            _close(got, want)
            _close(got, qm._launch_group_ln(x, g, b, q, bias, 1e-5,
                                            form="cuda_core"))


@pytest.mark.parametrize("rows", [2, 3, 8, 17, 64, 256])
@pytest.mark.parametrize("bits", [4, 8])
def test_group_norm_mma_kernel(dev, rows, bits, monkeypatch):
    """qmm_group_norm's tensor-core form against the plain version
    (qmm_group_plain on rmsnorm_bf16's rows) and against the CUDA-core
    form, both forced, with K split (the card's SM count) and not split
    (one SM), bit for bit across two launches; quant_matmul_norm takes it
    from MMA_MIN_ROWS rows (counted under qmm_group_norm and again under
    qmm_group_norm_mma), and a group_form that answers "cuda_core" sends
    it to the CUDA-core form."""
    q = _qlin(dev, 1024, 300, bits, torch.bfloat16, pad_out=128)
    x = _x(dev, rows, 1024) * 3 + 0.5
    nw = (torch.rand(1024, generator=torch.Generator().manual_seed(2))
          + 0.5).to(torch.bfloat16).to(dev)
    want = qm.qmm_group_plain(qm.rmsnorm_bf16(x, nw, 1e-5), q)
    sms = _build.sms(0)
    for n_sm, split in ((sms, True), (1, False)):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        plan = qm.mma_plan(rows, q.out_physical, q.qweight.shape[0],
                           q.group_size, n_sm)
        assert (plan[1] > 1) == split
        before = dict(qm.launches)
        got = qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm", form="mma")
        assert qm.launches["qmm_group_norm_mma"] == \
            before.get("qmm_group_norm_mma", 0) + 1
        _close(got, want)
        _close(got, qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm",
                                     form="cuda_core"))
        assert torch.equal(got, qm._launch_group(
            x, nw, q, 1e-5, "qmm_group_norm", form="mma"))
    route = qm.group_form
    for form_of, mma in ((route, rows >= qm.MMA_MIN_ROWS),
                         (lambda *a: "cuda_core", 0)):
        monkeypatch.setattr(qm, "group_form", form_of)
        before = dict(qm.launches)
        _close(qm.quant_matmul_norm(x, nw, q)[:, :300],
               want[:, :300])
        assert qm.launches["qmm_group_norm"] == \
            before.get("qmm_group_norm", 0) + 1
        assert qm.launches["qmm_group_norm_mma"] == \
            before.get("qmm_group_norm_mma", 0) + mma


@pytest.mark.parametrize("rows", [2, 8, 64])
def test_group_norm_mma_in_a_cuda_graph(dev, rows):
    """The tensor-core form captured in a CUDA graph (the pre-pass and the
    tile as two plain launches): replays equal the eager launch bit for
    bit, also after x changes in place."""
    q = _qlin(dev, 2048, 640, 4, torch.bfloat16)
    x = _x(dev, rows, 2048) * 3
    nw = (torch.rand(2048, generator=torch.Generator().manual_seed(4))
          + 0.5).to(torch.bfloat16).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.quant_matmul_norm(x, nw, q)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.quant_matmul_norm(x, nw, q)
    for seed in (1, 2):
        x.copy_(_x(dev, rows, 2048, seed=seed) * 3)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qm.quant_matmul_norm(x, nw, q))
        _close(out, qm.qmm_group_plain(qm.rmsnorm_bf16(x, nw, 1e-5), q)[
            :, :640])


@pytest.mark.parametrize("rows", [1, 8, 64, 256])
def test_group_norm_prepass(dev, rows, monkeypatch):
    """The tensor-core form's RMSNorm pre-pass: its bf16 rows are
    rmsnorm_bf16's (within one bf16 ulp, equal but where rsqrt and the sum
    order move a rounding: at most 1e-3 of the values), and they are the
    CUDA-core prologue's to the bit as far as the output shows: the
    CUDA-core form with its prologue equals the CUDA-core form without a
    norm on the pre-pass's rows, bit for bit (both unsplit)."""
    monkeypatch.setattr(qm, "_SPLITS", 1)
    q = _qlin(dev, 4096, 512, 4, torch.bfloat16)
    x = _x(dev, rows, 4096) * 3 + 0.25
    nw = (torch.rand(4096, generator=torch.Generator().manual_seed(3))
          + 0.5).to(torch.bfloat16).to(dev)
    xn = torch.empty_like(x)
    qm._launch_group_norm_mma(x, nw, q, 1e-5, xn=xn)
    ref = qm.rmsnorm_bf16(x, nw, 1e-5)
    ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert ((xn.float() - ref.float()).abs() <= ulp).all()
    assert (xn != ref).float().mean().item() <= 1e-3
    fused = qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm",
                             form="cuda_core")
    assert torch.equal(fused, qm._launch_group(xn, None, q, 0.0, "qmm_group",
                                               form="cuda_core"))


# -- qmm_chunk's tensor-core form (csrc/quant_matmul_mma.cu) and -------------
# -- qmm_norm_w4a8's (csrc/quant_matmul_w4a8_mma.cu) --------------------------

@pytest.mark.parametrize("rows", [2, 3, 8, 17, 64, 256])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [64, 192])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_chunk_mma_kernel(dev, rows, bits, group, sdt, monkeypatch):
    """qmm_chunk's tensor-core form against qmm_chunk_plain and against
    the CUDA-core form, both forced, with K split (the card's SM count)
    and not split (one SM), bit for bit across two launches, on a padded
    dout; quant_matmul takes it from CHUNK_MMA_MIN_ROWS rows (counted
    under qmm_chunk and again under qmm_chunk_mma), and a chunk_form that
    answers "cuda_core" sends it to the CUDA-core form."""
    q = _qlin(dev, 768, 300, bits, sdt, pad_out=128, group=group)
    x = _x(dev, rows, 768, seed=rows) * 2
    want = qm.qmm_chunk_plain(x, q)
    sms = _build.sms(0)
    for n_sm, split in ((sms, True), (1, False)):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        plan = qm.mma_plan(rows, q.out_physical, q.qweight.shape[0],
                           q.group_size, n_sm)
        assert (plan[1] > 1) == split
        before = dict(qm.launches)
        got = qm._launch_chunk(x, q, form="mma")
        assert qm.launches["qmm_chunk_mma"] == \
            before.get("qmm_chunk_mma", 0) + 1
        _close(got, want)
        _close(got, qm._launch_chunk(x, q, form="cuda_core"))
        assert torch.equal(got, qm._launch_chunk(x, q, form="mma"))
    route = qm.chunk_form
    for form_of, mma in ((route, rows >= qm.CHUNK_MMA_MIN_ROWS),
                         (lambda *a: "cuda_core", 0)):
        monkeypatch.setattr(qm, "chunk_form", form_of)
        assert qm.route(x, q)[0] == "qmm_chunk"
        before = dict(qm.launches)
        _close(qm.quant_matmul(x, q), want[:, :300])
        assert qm.launches["qmm_chunk"] == before.get("qmm_chunk", 0) + 1
        assert qm.launches["qmm_chunk_mma"] == \
            before.get("qmm_chunk_mma", 0) + mma


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_chunk_mma_rounding_point(dev, bits, sdt, monkeypatch):
    """Each weight is scaled and rounded to bf16 before the mma: with
    one-hot rows (row r = e_k(r), k over the int4 lo and hi halves alike)
    every output is one product, x 1 times a weight, so the tensor-core
    form's rows equal qmm_chunk_plain's bf16 weight rows bit for bit
    (bf16 scales: one rounding of the exact product; f32 scales: the f32
    product, then bf16), with K split and not."""
    q = _qlin(dev, 1024, 384, bits, sdt, group=64)
    ks = torch.tensor([0, 1, 63, 64, 300, 511, 512, 513, 700, 1023] * 2,
                      device=dev)
    ks[10:] = (ks[10:] * 7 + 5) % 1024
    x = torch.zeros(len(ks), 1024, dtype=torch.bfloat16, device=dev)
    x[torch.arange(len(ks), device=dev), ks] = 1
    w = qm._weight_values(q)
    w = (w.reshape(q.scales.shape[0], 64, -1) * q.scales.float()[:, None]
         ).reshape(w.shape).to(torch.bfloat16)
    sms = _build.sms(0)
    for n_sm, split in ((sms, True), (1, False)):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        plan = qm.mma_plan(len(ks), 384, q.qweight.shape[0], 64, n_sm)
        assert (plan[1] > 1) == split
        got = qm._launch_chunk(x, q, form="mma")
        assert torch.equal(got, w[ks])
        assert torch.equal(got, qm.qmm_chunk_plain(x, q))


@pytest.mark.parametrize("rows", [2, 8, 64])
def test_chunk_mma_in_a_cuda_graph(dev, rows):
    """The tensor-core form captured in a CUDA graph (the tile and the
    split sum as plain launches): replays equal the eager launch bit for
    bit, also after x changes in place."""
    q = _qlin(dev, 2048, 640, 4, torch.bfloat16, group=64)
    x = _x(dev, rows, 2048)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.quant_matmul(x, q)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = qm.launches["qmm_chunk_mma"]
    with torch.cuda.graph(graph):
        out = qm.quant_matmul(x, q)
    assert qm.launches["qmm_chunk_mma"] == before + 1
    for seed in (1, 2):
        x.copy_(_x(dev, rows, 2048, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qm.quant_matmul(x, q))
        _close(out, qm.qmm_chunk_plain(x, q)[:, :640])


@pytest.mark.parametrize("rows", [3, 8, 17, 64, 256])
@pytest.mark.parametrize("bits", [4, 8])
def test_norm_w4a8_mma_kernel(dev, rows, bits, knobs, monkeypatch):
    """qmm_norm_w4a8's tensor-core form (the RMSNorm in the quantize
    pre-pass, then qmm_w4a8_mma's tile) against qmm_norm_w4a8_plain and
    against the CUDA-core form, both forced, K split and not, bit for bit
    across two launches, bf16 and f32 scales, a padded dout;
    quant_matmul_norm under "w4a8" takes it from W4A8_MMA_MIN_ROWS rows
    (counted under qmm_norm_w4a8 and qmm_norm_w4a8_mma), and a w4a8_form
    that answers "cuda_core" sends it to the CUDA-core form."""
    x = _x(dev, rows, 1024, seed=rows) * 3 + 0.5
    nw = (torch.rand(1024, generator=torch.Generator().manual_seed(2))
          + 0.5).to(torch.bfloat16).to(dev)
    sms = _build.sms(0)
    for sdt in (torch.bfloat16, torch.float32):
        q = _qlin(dev, 1024, 300, bits, sdt, pad_out=128)
        want = qm.qmm_norm_w4a8_plain(x, nw, q, 1e-5)
        for n_sm in (sms, 1):
            monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
            before = dict(qm.launches)
            got = qm._launch_w4a8(x, q, nw, 1e-5, form="mma")
            assert qm.launches["qmm_norm_w4a8_mma"] == \
                before.get("qmm_norm_w4a8_mma", 0) + 1
            assert qm.launches["qmm_w4a8_mma"] == \
                before.get("qmm_w4a8_mma", 0)
            _close(got, want)
            _close(got, qm._launch_w4a8(x, q, nw, 1e-5, form="cuda_core"))
            assert torch.equal(got, qm._launch_w4a8(x, q, nw, 1e-5,
                                                    form="mma"))
    knobs(variant="w4a8")
    route = qm.w4a8_form
    for form_of, mma in ((route, rows >= qm.W4A8_MMA_MIN_ROWS),
                         (lambda *a: "cuda_core", 0)):
        monkeypatch.setattr(qm, "w4a8_form", form_of)
        before = dict(qm.launches)
        _close(qm.quant_matmul_norm(x, nw, q), want[:, :300])
        assert qm.launches["qmm_norm_w4a8"] == \
            before.get("qmm_norm_w4a8", 0) + 1
        assert qm.launches["qmm_norm_w4a8_mma"] == \
            before.get("qmm_norm_w4a8_mma", 0) + mma


@pytest.mark.parametrize("rows", [3, 8, 64, 256])
def test_norm_w4a8_prepass(dev, rows):
    """The RMSNorm quantize pre-pass of qmm_norm_w4a8's tensor-core form:
    its xq and sx equal, bit for bit, the int8 quantize of the rows that
    qmm_group_norm's pre-pass writes (the CUDA-core prologue's rows, the
    same rms_norm_rinv / rms_norm_value): through qmm_w4a8_mma's own
    pre-pass and through quantize_rows_i8."""
    q = _qlin(dev, 4096, 512, 4, torch.bfloat16)
    x = _x(dev, rows, 4096) * 3 + 0.25
    nw = (torch.rand(4096, generator=torch.Generator().manual_seed(3))
          + 0.5).to(torch.bfloat16).to(dev)
    xq = torch.empty(rows, 4096, dtype=torch.int8, device=dev)
    sx = torch.empty(rows, dtype=torch.float32, device=dev)
    qm._launch_w4a8_mma(x, q, nw, 1e-5, xq=xq, sx=sx)
    xn = torch.empty_like(x)
    qm._launch_group_norm_mma(x, nw, q, 1e-5, xn=xn)
    xq2, sx2 = torch.empty_like(xq), torch.empty_like(sx)
    qm._launch_w4a8_mma(xn, q, xq=xq2, sx=sx2)
    assert torch.equal(xq, xq2) and torch.equal(sx, sx2)
    xq3, sx3 = qm.quantize_rows_i8(xn)
    assert torch.equal(xq, xq3) and torch.equal(sx, sx3[:, 0])


def test_w4a8_and_ln_mma_launch_counts(dev):
    """quant_matmul under "w4a8" and quant_matmul_ln launch the
    tensor-core forms from their thresholds, counted under the kernel's
    name and again under name + "_mma"; one row the CUDA-core forms only.
    The fused-norm W4A8 kernel counts its tensor-core form under
    qmm_norm_w4a8_mma, not qmm_w4a8_mma."""
    q = _qlin(dev, 2048, 512, 4, torch.bfloat16)
    q8 = _qlin(dev, 1024, 384, 8, torch.float32)
    gamma, beta = _ln_inputs(dev, 1024)
    bias = _x(dev, 1, 384, seed=5)[0]
    for rows in (256, 64, 8, qm.W4A8_MMA_MIN_ROWS, qm.MMA_MIN_ROWS, 1):
        before = dict(qm.launches)
        x = _x(dev, rows, 2048)
        _close(qm.quant_matmul(x, q, variant="w4a8"),
               qm.qmm_w4a8_plain(x, q))
        assert qm.launches["qmm_w4a8"] == before.get("qmm_w4a8", 0) + 1
        assert qm.launches["qmm_w4a8_mma"] == before.get(
            "qmm_w4a8_mma", 0) + (rows >= qm.W4A8_MMA_MIN_ROWS)
        x = _x(dev, rows, 1024)
        _close(qm.quant_matmul_ln(x, gamma, beta, q8, bias=bias),
               qm.qmm_group_ln_plain(x, gamma, beta, q8, bias, 1e-5))
        assert qm.launches["qmm_group_ln"] == \
            before.get("qmm_group_ln", 0) + 1
        assert qm.launches["qmm_group_ln_mma"] == before.get(
            "qmm_group_ln_mma", 0) + (rows >= qm.MMA_MIN_ROWS)
    before = dict(qm.launches)
    nw = torch.ones(2048, dtype=torch.bfloat16, device=dev)
    qm._launch_w4a8(_x(dev, 8, 2048), q, nw, 1e-5)
    assert qm.launches["qmm_norm_w4a8"] == \
        before.get("qmm_norm_w4a8", 0) + 1
    assert qm.launches["qmm_norm_w4a8_mma"] == \
        before.get("qmm_norm_w4a8_mma", 0) + (8 >= qm.W4A8_MMA_MIN_ROWS)
    assert qm.launches["qmm_w4a8_mma"] == before.get("qmm_w4a8_mma", 0)


# -- the split form of the dense decode attention, and flash_attention's --
# -- cp.async ring at the shapes that hit its first and last stages --

def _decode_inputs(dev, cache, H, Hkv, S, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, H, 1, D, generator=g, device=dev).to(torch.bfloat16)
    if cache == "bf16":
        return q, tuple(torch.randn(1, Hkv, S, D, generator=g, device=dev)
                        .to(torch.bfloat16) for _ in range(2))
    kv = tuple(torch.randint(-127, 128, (1, Hkv, S, D), generator=g,
                             device=dev, dtype=torch.int8) for _ in range(2))
    sc = tuple(torch.rand(1, Hkv, S, generator=g, device=dev) * 0.015
               + 0.005 for _ in range(2))
    return q, kv + sc


def _decode(cache, q, kv, pos, **kw):
    if cache == "bf16":
        return att.flash_decode(q, *kv, pos, **kw)
    return att.flash_decode_q8(q, *kv, pos, **kw)


def _decode_plain(cache, q, kv, pos):
    if cache == "bf16":
        return att.flash_decode_plain(q, *kv, pos)
    return att.flash_decode_q8_plain(q, *kv, pos)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv", [(32, 32), (32, 8)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_split_form(dev, cache, H, Hkv, D):
    """B 1 takes the split form: each pos against the plain version and
    against the forced unsplit form; one launch of the kernel and one of
    the merge a call."""
    S = 1100
    q, kv = _decode_inputs(dev, cache, H, Hkv, S, D, H + Hkv + D)
    assert att.decode_splits(1, Hkv, S, _build.sms(0)) > 1
    kname = "flash_decode" if cache == "bf16" else "flash_decode_q8"
    for p in (0, 1, 255, 256, 1024, S - 1):
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        before = dict(att.launches)
        got = _decode(cache, q, kv, pos)
        assert att.launches[kname] == before.get(kname, 0) + 1
        assert att.launches["flash_decode_merge"] == \
            before.get("flash_decode_merge", 0) + 1
        assert torch.isfinite(got.float()).all()
        _close(got, _decode_plain(cache, q, kv, pos))
        _close(got, _decode(cache, q, kv, pos, _splits=1))


def test_flash_decode_merge_kernel(dev):
    """The merge alone on partials with empty splits (l = 0, m = -inf)."""
    g = torch.Generator(device=dev).manual_seed(7)
    for D in (64, 128):
        part = torch.randn(3, 4, 5, D + 2, generator=g, device=dev)
        part[..., D + 1] = part[..., D + 1].abs() + 0.5
        part[:, :, 1, D:] = torch.tensor([float("-inf"), 0.0], device=dev)
        part[0, :, :4, D:] = torch.tensor([float("-inf"), 0.0], device=dev)
        before = att.launches["flash_decode_merge"]
        got = att.flash_decode_merge(part)
        assert att.launches["flash_decode_merge"] == before + 1
        _close(got, att.flash_decode_merge_plain(part).to(torch.bfloat16))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_split_form_in_a_cuda_graph(dev, cache):
    """One captured split launch stays right as pos moves between
    replays: the split count comes from shapes, the bounds from pos on the
    device."""
    S, H, Hkv, D = 1100, 32, 8, 128
    q, kv = _decode_inputs(dev, cache, H, Hkv, S, D, 3)
    pos = torch.tensor([5], dtype=torch.int32, device=dev)
    _decode(cache, q, kv, pos)            # build and load outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _decode(cache, q, kv, pos)
    for p in (0, 700, 63, 1099, 1024, 5):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        _close(out, _decode_plain(cache, q, kv, pos))


@pytest.mark.parametrize("S", [1, 65, 129, 1023, 1024, 1025])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ring(dev, S, D, causal):
    """The cp.async ring's first and last stages and the ragged tail."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(1, 4, S, D, generator=g).mul(2).to(torch.bfloat16)
               .to(dev) for _ in range(3))
    want = fa.mha_plain(q, k, v, causal)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, causal)
    assert fa.launches["flash_attention"] == before + 1
    _close(got, want)


# -- the any-type attention form (csrc/attention_any.cuh): every float ----
# -- type and head dim the TPU kernels take ---------------------------------

ANY_DECODE = [(torch.float32, 16, torch.float32), (torch.float16, 64,
                                                   torch.float16),
              (torch.bfloat16, 8, torch.bfloat16),
              (torch.bfloat16, 256, torch.bfloat16),
              (torch.float32, 96, torch.bfloat16),
              (torch.float16, 128, torch.float32),
              (torch.bfloat16, 128, torch.float16),
              (torch.float16, 72, torch.float16)]


def _any_decode_inputs(dev, qdt, D, cdt, B, H, Hkv, S, seed):
    """q, a float cache (cdt) and an INT8 cache with its scales; rows past
    pos NaN (float cache) or NaN-scaled (INT8 cache)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, 1, D, generator=g, device=dev).to(qdt)
    kc, vc = (torch.randn(B, Hkv, S, D, generator=g, device=dev).to(cdt)
              for _ in range(2))
    kq, vq = (torch.randint(-127, 128, (B, Hkv, S, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, Hkv, S, generator=g, device=dev) * 0.015 + 0.005
              for _ in range(2))
    pos = _ragged_pos(dev, B, S, seed)
    return q, (kc, vc), (kq, vq, ks, vs), pos


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("qdt,D,cdt", ANY_DECODE)
def test_flash_decode_any_form(dev, qdt, D, cdt, splits):
    """flash_decode and flash_decode_q8 outside the fast kernels' types
    and head dims (an f32 q or cache, a q dtype other than a 16-bit
    cache's, D other than 64 and 128), unsplit and split (with the
    any-type merge where the fast merge does not take it), against the
    plain versions; rows past pos hold NaN and are never read; the result
    is in q's dtype."""
    B, H, Hkv, S = 3, 8, 2, 300
    q, (kc, vc), (kq, vq, ks, vs), pos = _any_decode_inputs(
        dev, qdt, D, cdt, B, H, Hkv, S, D + splits)
    want = att.flash_decode_plain(q, kc, vc, pos)
    want8 = att.flash_decode_q8_plain(q, kq, vq, ks, vs, pos)
    dead = (torch.arange(S, device=dev)[None] > pos[:, None])[:, None] \
        .expand(B, Hkv, S)
    kc[dead] = float("nan")
    vc[dead] = float("nan")
    ks[dead] = float("nan")
    vs[dead] = float("nan")
    fast = att.fast_form(qdt, cdt, D)
    before = dict(att.launches)
    got = att.flash_decode(q, kc, vc, pos, _splits=splits)
    got8 = att.flash_decode_q8(q, kq, vq, ks, vs, pos, _splits=splits)
    assert got.dtype == got8.dtype == qdt
    assert torch.isfinite(got.float()).all()
    assert torch.isfinite(got8.float()).all()
    _close(got, want)
    _close(got8, want8)
    assert att.launches["flash_decode_any"] == \
        before.get("flash_decode_any", 0) + (not fast)
    assert att.launches["flash_decode_q8_any"] == \
        before.get("flash_decode_q8_any", 0) + (not att.fast_form(
            qdt, torch.int8, D))
    assert att.launches["flash_decode_merge"] == \
        before.get("flash_decode_merge", 0) + 2 * (splits > 1)


@pytest.mark.parametrize("D", [8, 16, 96, 256])
@pytest.mark.parametrize("odt", [torch.bfloat16, torch.float16,
                                 torch.float32])
def test_flash_decode_merge_any(dev, D, odt):
    """The any-type merge on partials with empty splits, more splits than
    D, out in each float type."""
    g = torch.Generator(device=dev).manual_seed(D)
    part = torch.randn(2, 3, 24, D + 2, generator=g, device=dev)
    part[..., D + 1] = part[..., D + 1].abs() + 0.5
    part[:, :, 1, D:] = torch.tensor([float("-inf"), 0.0], device=dev)
    before = att.launches["flash_decode_merge_any"]
    got = att.flash_decode_merge(part, odt)
    assert att.launches["flash_decode_merge_any"] == before + 1
    _close(got, att.flash_decode_merge_plain(part).to(odt))


@pytest.mark.parametrize("S", [1, 17, 63, 65, 77, 200, 257])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 16), (torch.float16, 64),
                                     (torch.bfloat16, 96),
                                     (torch.float16, 96),
                                     (torch.bfloat16, 8),
                                     (torch.float32, 256),
                                     (torch.float16, 136),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 8),
                                     (torch.float32, 72),
                                     (torch.float32, 128),
                                     (torch.float32, 136)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_any_form(dev, dtype, D, causal, S):
    """flash_attention at every float type and head dim against the plain
    version, in q's dtype; f32 and D 136-256 take the any-type form, a
    16-bit dtype at D up to 128 the tensor-core kernel. S crosses the
    any-type form's 64-row query tile and its 64- (D > 128: 32-) row key
    tile; B * H = 6. f32 is held within 1e-5 of max|plain| (the plain
    version in f32, TF32 off: both sides f32, sums in another order)."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(2, 3, S, D, generator=g).mul(2).to(dtype).to(dev)
               for _ in range(3))
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, causal)
    assert got.dtype == dtype
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = fa.mha_plain(q, k, v, causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _close(got, want)
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    assert fa.launches["flash_attention_any"] == \
        before.get("flash_attention_any", 0) + (not att.fast_prefill(dtype, D))


def _paged_any_case(dev, rep, P, D, qdt, pdt, seed):
    """_paged_case's table and positions at head dim D, q in qdt and
    float pages in pdt (INT8 pages when pdt is int8)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Hkv, MP = 5, 2, 6
    N = B * MP + 3
    pos = torch.tensor([0, P - 1, P, 3 * P + 5, MP * P - 1],
                       dtype=torch.int32, device=dev)
    table = torch.randperm(N - 1, generator=g, device=dev)[:B * MP].add(1) \
        .reshape(B, MP).to(torch.int32)
    q = torch.randn(B, Hkv * rep, 1, D, generator=g, device=dev).to(qdt)
    if pdt == torch.int8:
        kp, vp = (torch.randint(-127, 128, (N, Hkv, P, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(N, Hkv, P, generator=g, device=dev) * 0.015
                  + 0.005 for _ in range(2))
        return (q, kp, vp, ks, vs, table, pos)
    kp, vp = (torch.randn(N, Hkv, P, D, generator=g, device=dev).to(pdt)
              for _ in range(2))
    return (q, kp, vp, table, pos)


@pytest.mark.parametrize("qdt,pdt", [(torch.float16, torch.float16),
                                     (torch.float16, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("rep", [1, 4])
def test_paged_kernels_at_head_dim_64(dev, qdt, pdt, rep):
    """Both paged kernels at head dim 64 (a bf16 or f16 q over pages of its
    dtype or INT8 takes the fast kernels, anything else the any-type
    form) against their plain versions, in q's dtype."""
    for kname, dt, fn, plain in (
            ("paged_flash_decode", pdt, pa.paged_flash_decode,
             pa.paged_decode_plain),
            ("paged_flash_decode_q8", torch.int8, pa.paged_flash_decode_q8,
             pa.paged_decode_q8_plain)):
        args = _paged_any_case(dev, rep, 16, 64, qdt, dt, rep + 3)
        before = dict(pa.launches)
        got = fn(*args)
        assert got.dtype == qdt
        assert pa.launches[kname] == before.get(kname, 0) + 1
        assert pa.launches[kname + "_any"] == before.get(
            kname + "_any", 0) + (not att.fast_form(qdt, dt, 64))
        _close(got, plain(*args))


# -- the fast 16-bit forms: the tensor-core prefill at bf16 / f16 and ----
# -- every head dim up to 128, the f16 dense and paged decode on -----------
# -- flash_decode.cuh's body -------------------------------------------------

@pytest.mark.parametrize("S", [1, 77, 200, 1025])
@pytest.mark.parametrize("D", [8, 16, 64, 72, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fast_forms(dev, dtype, D, causal, S):
    """The tensor-core prefill in f16 and bf16 at every head dim up to 128
    (below 64 / 128 zero-padded in shared memory, through every stage of
    the ring) against the plain version, in q's dtype; the counters show
    the fast kernel ran, not the any-type form."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(2, 3, S, D, generator=g).mul(2).to(dtype).to(dev)
               for _ in range(3))
    assert att.fast_prefill(dtype, D)
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, causal)
    assert fa.launches["flash_attention"] == \
        before.get("flash_attention", 0) + 1
    assert fa.launches["flash_attention_any"] == \
        before.get("flash_attention_any", 0)
    _close(got, fa.mha_plain(q, k, v, causal))


@pytest.mark.parametrize("splits", [1, 5, None])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_f16_fast_forms(dev, D, rep, splits):
    """An f16 q over an f16 and over an INT8 cache on the fast kernels,
    unsplit, split in 5 and (batch 1) in the count the wrapper picks,
    with the f16 merge; rows past pos NaN; against the plain versions, in
    f16, with no any-type launch."""
    f16 = torch.float16
    B, Hkv, S = (1, 2, 1100) if splits is None else (3, 2, 300)
    q, (kc, vc), (kq, vq, ks, vs), pos = _any_decode_inputs(
        dev, f16, D, f16, B, Hkv * rep, Hkv, S, D + rep + (splits or 0))
    want = att.flash_decode_plain(q, kc, vc, pos)
    want8 = att.flash_decode_q8_plain(q, kq, vq, ks, vs, pos)
    dead = (torch.arange(S, device=dev)[None] > pos[:, None])[:, None] \
        .expand(B, Hkv, S)
    for t in (kc, vc, ks, vs):
        t[dead] = float("nan")
    split = (splits or att.launch_splits(B, Hkv, S)) > 1
    assert att.fast_form(f16, f16, D) and att.fast_form(f16, torch.int8, D)
    before = dict(att.launches)
    got = att.flash_decode(q, kc, vc, pos, _splits=splits)
    got8 = att.flash_decode_q8(q, kq, vq, ks, vs, pos, _splits=splits)
    for kname in ("flash_decode", "flash_decode_q8"):
        assert att.launches[kname] == before.get(kname, 0) + 1
    assert att.launches["flash_decode_merge"] == \
        before.get("flash_decode_merge", 0) + 2 * split
    for kname in ("flash_decode_any", "flash_decode_q8_any",
                  "flash_decode_merge_any"):
        assert att.launches[kname] == before.get(kname, 0)
    assert torch.isfinite(got.float()).all()
    assert torch.isfinite(got8.float()).all()
    _close(got, want)
    _close(got8, want8)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 4])
def test_paged_f16_fast_forms(dev, rep, D):
    """Both paged kernels at 8 slots with an f16 q over f16 and over INT8
    pages take the fast kernels (no any-type launch) and agree with their
    plain versions, in f16; no dead row is read."""
    for kname, q8, fn, plain in (
            ("paged_flash_decode", False, pa.paged_flash_decode,
             pa.paged_decode_plain),
            ("paged_flash_decode_q8", True, pa.paged_flash_decode_q8,
             pa.paged_decode_q8_plain)):
        args = _paged_case(dev, rep, 64, q8, rep + D, B=8, D=D,
                           qdt=torch.float16)
        before = dict(pa.launches)
        got = fn(*args)
        assert got.dtype == torch.float16
        assert pa.launches[kname] == before.get(kname, 0) + 1
        assert pa.launches[kname + "_any"] == before.get(kname + "_any", 0)
        assert torch.isfinite(got.float()).all()
        _close(got, plain(*args))


def _split_weight(dev, kind, bits, group, sdt):
    """A 4096 x 4096 weight (wo's shape: 32 column tiles) for qmm_group,
    qmm_chunk or qmm_slab (paired int4)."""
    w = torch.randn(4096, 4096, generator=torch.Generator().manual_seed(
        bits + group))
    q = quantize_weight(w, bits=bits, group_size=group,
                        paired=kind == "qmm_slab")
    return QuantizedLinear(q.qweight.to(dev), q.scales.to(sdt).to(dev), bits,
                           q.group_size)


SPLIT_CASES = [("qmm_group", 4, 128), ("qmm_group", 8, 128),
                 ("qmm_chunk", 4, 64), ("qmm_chunk", 8, 64),
                 ("qmm_chunk", 4, 128), ("qmm_chunk", 8, 128),
                 ("qmm_slab", 4, 128)]


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16,
                                 torch.float32])
@pytest.mark.parametrize("kind,bits,group", SPLIT_CASES)
def test_k_split_at_one_row(dev, kind, bits, group, xdt):
    """At 1 row (and at 2 where the call stays on the CUDA cores) a short
    grid takes the split form, once a call: against the plain version,
    bit for bit across two launches, and within the tolerance of the
    unsplit form, forced. At 8 rows (4-row blocks) the call stays
    unsplit, and the split form, forced at 2, holds to the same checks.
    Rows that qmm_group, qmm_chunk or qmm_slab sends to its tensor-core
    form (a bf16 or f16 x from the form's threshold) are not the
    split's."""
    q = _split_weight(dev, kind, bits, group, torch.bfloat16)
    variant = "chunk" if kind == "qmm_chunk" else None
    plain = {"qmm_group": qm.qmm_group_plain, "qmm_chunk": qm.qmm_chunk_plain,
             "qmm_slab": qm.qmm_slab_plain}[kind]
    for rows in (1, 2, 8):
        x = _x(dev, rows, 4096, seed=rows).to(xdt)
        if kind == "qmm_group" and \
                qm.group_form(rows, xdt, False) == "mma":
            continue
        if kind == "qmm_chunk" and \
                qm.chunk_form(rows, xdt, group) == "mma":
            continue
        if kind == "qmm_slab" and qm.slab_form(rows, xdt, False) == "mma":
            continue
        splits = qm.group_splits(rows, 4096, q.qweight.shape[0],
                                 q.group_size, _build.sms(0))
        assert (splits == 1) if rows == 8 else (splits > 1)
        assert qm.route(x, q, variant)[0] == kind
        if rows == 8:
            before = dict(qm.launches)
            qm.quant_matmul(x, q, variant)
            assert qm.launches[kind + "_split"] == \
                before.get(kind + "_split", 0)
            qm._SPLITS = 2
        before = dict(qm.launches)
        try:
            got = qm.quant_matmul(x, q, variant)
            again = qm.quant_matmul(x, q, variant)
        finally:
            qm._SPLITS = None
        assert qm.launches[kind] == before.get(kind, 0) + 2
        assert qm.launches[kind + "_split"] == \
            before.get(kind + "_split", 0) + 2
        assert torch.equal(got, again)
        _close(got, plain(x, q))
        qm._SPLITS = 1
        try:
            unsplit = qm.quant_matmul(x, q, variant)
        finally:
            qm._SPLITS = None
        assert qm.launches[kind + "_split"] == \
            before.get(kind + "_split", 0) + 2
        _close(got, unsplit)


def test_k_split_in_a_cuda_graph(dev):
    """A captured split launch replays right with new x each time: the
    tile counters the last block sets back stay zero between launches."""
    q = _split_weight(dev, "qmm_group", 4, 128, torch.bfloat16)
    x = _x(dev, 1, 4096)
    qm.quant_matmul(x, q)                 # build, load, counters outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.quant_matmul(x, q)
    for seed in (3, 4, 5):
        x.copy_(_x(dev, 1, 4096, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, qm.qmm_group_plain(x, q))
        assert torch.equal(out, qm.quant_matmul(x, q))
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def _on_two_streams(q, xs, rounds=5, call=None):
    """quant_matmul(x, q) (or call(x)) for every x of xs on each of two
    streams, both held behind a sleep while the launches queue, so that
    the two streams' launches run at the same time. Returns each stream's
    outputs."""
    call = call or (lambda x: qm.quant_matmul(x, q))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(rounds):
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(5_000_000)
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].extend(call(x) for x in xs)
    torch.cuda.synchronize()
    return streams, got


def test_k_split_on_two_streams(dev):
    """Split launches on two streams at once each have their own tile
    counters: every output equals the same call made alone, bit for bit,
    and the counters are zero after."""
    q = _split_weight(dev, "qmm_group", 4, 128, torch.bfloat16)
    xs = [_x(dev, 1, 4096, seed=s) for s in range(8)]
    want = [qm.quant_matmul(x, q) for x in xs]
    streams, got = _on_two_streams(q, xs)
    keys = [(0, s.cuda_stream) for s in streams]
    assert qm._COUNTERS[keys[0]][1].data_ptr() != \
        qm._COUNTERS[keys[1]][1].data_ptr()
    for outs in got:
        for j, out in enumerate(outs):
            assert torch.equal(out, want[j % len(xs)])
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def test_k_split_f32_scales_and_padding(dev):
    """f32 scales, a padded dout (3 column tiles) and a weight with only
    two scale groups, whose split is capped at 2."""
    q = _qlin(dev, 512, 300, 4, torch.float32, pad_out=128)
    x = _x(dev, 1, 512)
    assert qm.group_splits(1, q.out_physical, q.qweight.shape[0],
                           q.group_size, _build.sms(0)) == 2
    before = qm.launches["qmm_group_split"]
    _close(qm.quant_matmul(x, q), qm.qmm_group_plain(x, q)[:, :300])
    assert qm.launches["qmm_group_split"] == before + 1


# -- the f32 decode on flash_decode.cuh's fast body, and qmm_group_norm's ----
# -- one-row form (csrc/quant_matmul_ring.cu) --------------------------------

F32_TOL = 1e-5               # f32 attention: of max|plain|


def _close_f32(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= F32_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("splits", [1, 5, None])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_f32_fast_forms(dev, D, rep, splits):
    """An f32 q over an f32 and over an INT8 cache on the fast kernels,
    unsplit, split in 5 and (batch 1) in the count the wrapper picks,
    with the f32 merge; ragged pos with 0 and the last row, rows past pos
    NaN; within 1e-5 of max|plain| (f32), with no any-type launch."""
    f32 = torch.float32
    B, Hkv, S = (1, 2, 1100) if splits is None else (3, 2, 300)
    q, (kc, vc), (kq, vq, ks, vs), pos = _any_decode_inputs(
        dev, f32, D, f32, B, Hkv * rep, Hkv, S, 2 * D + rep + (splits or 0))
    want = att.flash_decode_plain(q, kc, vc, pos)
    want8 = att.flash_decode_q8_plain(q, kq, vq, ks, vs, pos)
    dead = (torch.arange(S, device=dev)[None] > pos[:, None])[:, None] \
        .expand(B, Hkv, S)
    for t in (kc, vc, ks, vs):
        t[dead] = float("nan")
    split = (splits or att.launch_splits(B, Hkv, S)) > 1
    assert att.fast_form(f32, f32, D) and att.fast_form(f32, torch.int8, D)
    before = dict(att.launches)
    got = att.flash_decode(q, kc, vc, pos, _splits=splits)
    got8 = att.flash_decode_q8(q, kq, vq, ks, vs, pos, _splits=splits)
    for kname in ("flash_decode", "flash_decode_q8"):
        assert att.launches[kname] == before.get(kname, 0) + 1
    assert att.launches["flash_decode_merge"] == \
        before.get("flash_decode_merge", 0) + 2 * split
    for kname in ("flash_decode_any", "flash_decode_q8_any",
                  "flash_decode_merge_any"):
        assert att.launches[kname] == before.get(kname, 0)
    assert torch.isfinite(got).all() and torch.isfinite(got8).all()
    _close_f32(got, want)
    _close_f32(got8, want8)


@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 4])
def test_paged_f32_fast_forms(dev, rep, D, P):
    """Both paged kernels with an f32 q over f32 and over INT8 pages take
    the fast kernels (no any-type launch), pos at 0 and on both sides of
    page edges, dead rows NaN; within 1e-5 of max|plain| (f32)."""
    for kname, q8, fn, plain in (
            ("paged_flash_decode", False, pa.paged_flash_decode,
             pa.paged_decode_plain),
            ("paged_flash_decode_q8", True, pa.paged_flash_decode_q8,
             pa.paged_decode_q8_plain)):
        args = _paged_case(dev, rep, P, q8, rep + D + P,
                           B=5 if P == 16 else 8, D=D, qdt=torch.float32)
        before = dict(pa.launches)
        got = fn(*args)
        assert pa.launches[kname] == before.get(kname, 0) + 1
        assert pa.launches[kname + "_any"] == before.get(kname + "_any", 0)
        assert torch.isfinite(got).all()
        _close_f32(got, plain(*args))


def _within_bf16_ulp(got, want):
    """Within one bf16 ulp at max|want|."""
    ref = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** (math.floor(math.log2(ref)) - 7), (err, ref)


def _norm_w(dev, din, seed=2):
    return (torch.rand(din, generator=torch.Generator().manual_seed(seed))
            + 0.5).to(torch.bfloat16).to(dev)


# (din, dout, pad_out, group): a padded dout (3 tiles, 4 groups); columns
# no multiple of 16 (the 4-byte copies); two ring stages a group; wqkv's
# din over 8 tiles; a partial last tile of 16-byte aligned rows (400
# columns: the TMA boxes reach past dout_p)
RING_CASES = [(1024, 300, 128, 128), (1024, 260, 0, 128),
              (2048, 640, 0, 256), (4096, 1000, 128, 128),
              (1024, 400, 0, 128)]


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("din,dout,pad,group", RING_CASES)
def test_group_norm_ring_kernel(dev, din, dout, pad, group, sdt,
                                monkeypatch):
    """qmm_group_norm's one-row form against the plain version and the
    CUDA-core form, each within one bf16 ulp at max|plain|, at the card's
    SM count and at SM counts that share the tiles out otherwise (1: one
    block holds every unit; 3, 7: tiles shared by two or three blocks),
    bit for bit across two launches, the tile counters zero after."""
    q = _qlin(dev, din, dout, 4, sdt, pad_out=pad, group=group)
    x = _x(dev, 1, din) * 3 + 0.5
    nw = _norm_w(dev, din)
    want = qm.qmm_group_plain(qm.rmsnorm_bf16(x, nw, 1e-5), q)
    old = qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm",
                           form="cuda_core")
    for n_sm in (_build.sms(0), 1, 3, 7):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        before = dict(qm.launches)
        got = qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm", form="ring")
        assert qm.launches["qmm_group_norm_ring"] == \
            before.get("qmm_group_norm_ring", 0) + 1
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        _within_bf16_ulp(got, want)
        _within_bf16_ulp(got, old)
        assert torch.equal(got, qm._launch_group(
            x, nw, q, 1e-5, "qmm_group_norm", form="ring"))
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


# sha256 (first 16 hex digits) of qmm_group_norm_ring's bf16 output bits on
# the inputs of test_group_norm_ring_kernel, at 132 and 7 SMs, recorded on
# an NVIDIA H100 from the kernel's first source (cp.async copies, before
# the grid, copies and merge moved to csrc/ring.cuh and took TMA copies):
# (din, dout, pad, group, scales, SMs) -> digest
RING_BITS = {
    (1024, 300, 128, 128, "bf16", 132): "9bab3a8f33414dce",
    (1024, 300, 128, 128, "bf16", 7): "a487ee39ee9f5a3a",
    (1024, 300, 128, 128, "f32", 132): "4731c1f9f8fea715",
    (1024, 300, 128, 128, "f32", 7): "4731c1f9f8fea715",
    (1024, 260, 0, 128, "bf16", 132): "4697f6166bea6783",
    (1024, 260, 0, 128, "f32", 7): "267e42163a66bbab",
    (2048, 640, 0, 256, "bf16", 132): "fde2f32a646723cf",
    (2048, 640, 0, 256, "f32", 132): "d2927127e20a37b1",
    (2048, 640, 0, 256, "f32", 7): "8f5bbcded1bb28bf",
    (4096, 1000, 128, 128, "bf16", 7): "c42931a55a666e0a",
    (4096, 1000, 128, 128, "f32", 132): "00affb3cc72529d9",
    (4096, 12288, 0, 128, "bf16", 132): "d0cb634740f99d61",
    (4096, 12288, 0, 128, "bf16", 7): "e7771d9ad08584f1",
    (4096, 12288, 0, 128, "f32", 132): "3c64d69697ee9928",
    (4096, 22528, 0, 128, "bf16", 132): "0aeb3507f3e11d5c",
    (4096, 22528, 0, 128, "bf16", 7): "2a92585e122f9e2b",
    (4096, 22528, 0, 128, "f32", 7): "eec207b061e290ac",
}


@pytest.mark.parametrize("case", sorted(RING_BITS))
def test_group_norm_ring_bits_unchanged(dev, case, monkeypatch):
    """qmm_group_norm_ring's outputs are those of its first source bit for
    bit (RING_BITS): the shared ring header and its TMA copies move the
    same bytes into the same sums in the same order."""
    import hashlib
    din, dout, pad, group, sdt, n_sm = case
    q = _qlin(dev, din, dout, 4, {"bf16": torch.bfloat16,
                                  "f32": torch.float32}[sdt],
              pad_out=pad, group=group)
    monkeypatch.setattr(_build, "sms", lambda i: n_sm)
    out = qm._launch_group(_x(dev, 1, din) * 3 + 0.5, _norm_w(dev, din), q,
                           1e-5, "qmm_group_norm", form="ring")
    digest = hashlib.sha256(
        out.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
    assert digest == RING_BITS[case]


@pytest.mark.parametrize("bits,ring", [(4, True), (8, False)])
def test_group_norm_ring_route(dev, bits, ring):
    """quant_matmul_norm at one row of a bf16 x takes the ring form over
    an int4 weight (counted under qmm_group_norm and qmm_group_norm_ring)
    and the CUDA-core form over an int8 one; from two rows the
    tensor-core form."""
    q = _qlin(dev, 1024, 384, bits, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    for rows in (1, 2):
        x = _x(dev, rows, 1024) * 2
        before = dict(qm.launches)
        _within_bf16_ulp(qm.quant_matmul_norm(x, nw, q),
                         qm.qmm_group_plain(qm.rmsnorm_bf16(x, nw, 1e-5), q))
        assert qm.launches["qmm_group_norm"] == \
            before.get("qmm_group_norm", 0) + 1
        assert qm.launches["qmm_group_norm_ring"] == \
            before.get("qmm_group_norm_ring", 0) + (ring and rows == 1)
        assert qm.launches["qmm_group_norm_mma"] == \
            before.get("qmm_group_norm_mma", 0) + (rows >= qm.MMA_MIN_ROWS)


def test_group_norm_ring_in_a_cuda_graph(dev):
    """The ring form captured in a CUDA graph (8 tiles of 16 groups: 128
    units, one a block on the card, every tile shared by 16 blocks):
    replays with new x equal the eager launch bit for bit, and the tile
    counters stay zero between launches."""
    q = _qlin(dev, 4096, 1000, 4, torch.bfloat16, pad_out=128)
    x = _x(dev, 1, 4096) * 3
    nw = _norm_w(dev, 4096, seed=4)
    qm.quant_matmul_norm(x, nw, q)        # build, load, counters outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = qm.launches["qmm_group_norm_ring"]
    with torch.cuda.graph(graph):
        out = qm.quant_matmul_norm(x, nw, q)
    assert qm.launches["qmm_group_norm_ring"] == before + 1
    for seed in (3, 4, 5):
        x.copy_(_x(dev, 1, 4096, seed=seed) * 3)
        graph.replay()
        torch.cuda.synchronize()
        _within_bf16_ulp(out, qm.qmm_group_plain(
            qm.rmsnorm_bf16(x, nw, 1e-5), q)[:, :1000])
        assert torch.equal(out, qm.quant_matmul_norm(x, nw, q))
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def test_group_norm_ring_on_two_streams(dev):
    """Ring launches on two streams at once each have their own tile
    counters: every output equals the same call made alone, bit for bit,
    and the counters are zero after."""
    q = _qlin(dev, 4096, 1000, 4, torch.bfloat16, pad_out=128)
    nw = _norm_w(dev, 4096, seed=5)
    xs = [_x(dev, 1, 4096, seed=s) * 2 for s in range(8)]

    def call(x):
        return qm.quant_matmul_norm(x, nw, q)

    want = [call(x) for x in xs]
    before = qm.launches["qmm_group_norm_ring"]
    streams, got = _on_two_streams(q, xs, call=call)
    assert qm.launches["qmm_group_norm_ring"] == before + 2 * 5 * len(xs)
    for outs in got:
        for j, out in enumerate(outs):
            assert torch.equal(out, want[j % len(xs)])
    assert not any(c.any() for _, c in qm._COUNTERS.values())


# -- the W4A8 pair's one-row form (csrc/quant_matmul_w4a8_ring.cu) -----------

# (din, dout, pad_out, group, x): RING_CASES with bf16 and f32 scales
# beside a bf16 x, an f32 x (qmm_w4a8 only) and the RMSNorm ahead; w_down's
# 43 groups (11008 in) over a partial last tile
W4A8_RING_CASES = [(*c, xk) for c in RING_CASES for xk in ("bf16", "norm")] \
    + [(1024, 260, 0, 128, "f32"), (2048, 640, 0, 256, "f32"),
       (11008, 1000, 0, 128, "norm"), (11008, 1000, 0, 128, "bf16")]


def _w4a8_ring_inputs(dev, din, dout, pad, group, xk, sdt):
    q = _qlin(dev, din, dout, 4, sdt, pad_out=pad, group=group)
    x = _x(dev, 1, din) * 3 + 0.5
    if xk == "f32":
        x = x.float() * 1.3
    nw = _norm_w(dev, din) if xk == "norm" else None
    want = qm.qmm_w4a8_plain(x, q) if nw is None \
        else qm.qmm_norm_w4a8_plain(x, nw, q, 1e-5)
    return q, x, nw, want


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("din,dout,pad,group,xk", W4A8_RING_CASES)
def test_w4a8_ring_kernel(dev, din, dout, pad, group, xk, sdt, monkeypatch):
    """qmm_w4a8's and qmm_norm_w4a8's one-row form against the plain
    version and the CUDA-core form, each within one bf16 ulp at max|plain|,
    in x's type, at the card's SM count and at SM counts that share the
    tiles out otherwise (1, 3, 7), bit for bit across two launches, the
    tile counters zero after; counted under the kernel and its _ring
    name, not under the other forms."""
    q, x, nw, want = _w4a8_ring_inputs(dev, din, dout, pad, group, xk, sdt)
    name = "qmm_norm_w4a8" if nw is not None else "qmm_w4a8"
    old = qm._launch_w4a8(x, q, nw, 1e-5, form="cuda_core")
    for n_sm in (_build.sms(0), 1, 3, 7):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        before = dict(qm.launches)
        got = qm._launch_w4a8(x, q, nw, 1e-5, form="ring")
        assert qm.launches[name] == before.get(name, 0) + 1
        assert qm.launches[name + "_ring"] == \
            before.get(name + "_ring", 0) + 1
        assert qm.launches[name + "_mma"] == before.get(name + "_mma", 0)
        assert got.shape == want.shape and got.dtype == x.dtype
        _within_bf16_ulp(got, want)
        _within_bf16_ulp(got, old)
        assert torch.equal(got, qm._launch_w4a8(x, q, nw, 1e-5, form="ring"))
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


@pytest.mark.parametrize("bits,ring", [(4, True), (8, False)])
def test_w4a8_ring_route(dev, bits, ring, knobs):
    """quant_matmul under "w4a8" and quant_matmul_norm under the W4A8 knob
    take the ring form at one row of a bf16 (and, without the norm, f32) x
    over an int4 weight, the CUDA-core form over an int8 one and at two
    rows, the tensor-core form from W4A8_MMA_MIN_ROWS rows."""
    q = _qlin(dev, 1024, 384, bits, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    knobs(variant="w4a8")
    for rows in (1, 2, qm.W4A8_MMA_MIN_ROWS):
        for xdt, norm in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
            x = (_x(dev, rows, 1024) * 2).to(xdt)
            name = "qmm_norm_w4a8" if norm else "qmm_w4a8"
            before = dict(qm.launches)
            if norm:
                got = qm.quant_matmul_norm(x, nw, q)
                want = qm.qmm_norm_w4a8_plain(x, nw, q, 1e-5)
            else:
                got = qm.quant_matmul(x, q)
                want = qm.qmm_w4a8_plain(x, q)
            _within_bf16_ulp(got, want)
            assert qm.launches[name] == before.get(name, 0) + 1
            assert qm.launches[name + "_ring"] == \
                before.get(name + "_ring", 0) + (ring and rows == 1)
            assert qm.launches[name + "_mma"] == before.get(
                name + "_mma", 0) + (rows >= qm.W4A8_MMA_MIN_ROWS)


def test_w4a8_ring_in_a_cuda_graph(dev):
    """Both ring forms captured in one CUDA graph (wo's 4096 -> 4096 and
    w_gateup's 4096 -> 11264 halves: tiles shared by blocks): replays with
    new x equal the eager launches bit for bit, within one bf16 ulp of the
    plain versions, and the tile counters stay zero between launches."""
    q1 = _qlin(dev, 4096, 4096, 4, torch.bfloat16)
    q2 = _qlin(dev, 4096, 11264, 4, torch.bfloat16, seed=3)
    x = _x(dev, 1, 4096) * 3
    nw = _norm_w(dev, 4096, seed=4)

    def call():
        return (qm._launch_w4a8(x, q1), qm._launch_w4a8(x, q2, nw, 1e-5))

    call()                                 # build, load, counters outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(qm.launches)
    with torch.cuda.graph(graph):
        out = call()
    for name in ("qmm_w4a8_ring", "qmm_norm_w4a8_ring"):
        assert qm.launches[name] == before.get(name, 0) + 1
    for seed in (3, 4, 5):
        x.copy_(_x(dev, 1, 4096, seed=seed) * 3)
        graph.replay()
        torch.cuda.synchronize()
        _within_bf16_ulp(out[0], qm.qmm_w4a8_plain(x, q1))
        _within_bf16_ulp(out[1], qm.qmm_norm_w4a8_plain(x, nw, q2, 1e-5))
        for got, want in zip(out, call()):
            assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


# (din, dout, pad_out, group, x, scales, SMs): W4A8_RING_CASES' shapes and
# the batch-1 decode's (wqkv and w_gateup with the norm, wo, w_down and the
# lm_head without), at the card's 132 SMs and at 7
W4A8_RING_SHAPES = [(1024, 300, 128, 128, "norm"), (1024, 260, 0, 128, "f32"),
                    (2048, 640, 0, 256, "bf16"), (1024, 400, 0, 128, "bf16"),
                    (11008, 1000, 0, 128, "norm"),
                    (4096, 12288, 0, 128, "norm"),
                    (4096, 22528, 0, 128, "norm"), (4096, 4096, 0, 128, "f32"),
                    (11008, 4096, 0, 128, "bf16"),
                    (4096, 32000, 0, 128, "bf16")]


def _w4a8_ring_digest(dev, case):
    """sha256 (first 16 hex digits) of the ring form's output bits on
    _w4a8_ring_inputs(case) at case's SM count (_build.sms patched)."""
    import hashlib
    din, dout, pad, group, xk, sdt, n_sm = case
    q, x, nw, _ = _w4a8_ring_inputs(
        dev, din, dout, pad, group, xk,
        {"bf16": torch.bfloat16, "f32": torch.float32}[sdt])
    sms = _build.sms
    _build.sms = lambda i: n_sm
    try:
        out = qm._launch_w4a8(x, q, nw, 1e-5, form="ring")
    finally:
        _build.sms = sms
    bits = out.cpu().view(torch.int32 if out.dtype == torch.float32
                          else torch.int16)
    return hashlib.sha256(bits.numpy().tobytes()).hexdigest()[:16]


# sha256 (first 16 hex digits, _w4a8_ring_digest) of the outputs of
# qmm_w4a8_ring (x "bf16", "f32") and qmm_norm_w4a8_ring (x "norm") on
# W4A8_RING_SHAPES with bf16 and f32 scales at 132 and 7 SMs, recorded on an
# NVIDIA H100 from the sources before the ring took the paired stage and
# the programmatic launch: (din, dout, pad, group, x, scales, SMs) -> digest
W4A8_RING_BITS = {
    (1024, 300, 128, 128, 'norm', 'bf16', 132): "7702b9993bd7ec77",
    (1024, 300, 128, 128, 'norm', 'bf16', 7): "7702b9993bd7ec77",
    (1024, 300, 128, 128, 'norm', 'f32', 132): "14f751e06be2b81e",
    (1024, 300, 128, 128, 'norm', 'f32', 7): "14f751e06be2b81e",
    (1024, 260, 0, 128, 'f32', 'bf16', 132): "db572484a28b23e0",
    (1024, 260, 0, 128, 'f32', 'bf16', 7): "db572484a28b23e0",
    (1024, 260, 0, 128, 'f32', 'f32', 132): "15fc1e1708806b62",
    (1024, 260, 0, 128, 'f32', 'f32', 7): "5fd66573efc851e3",
    (2048, 640, 0, 256, 'bf16', 'bf16', 132): "96e0d31a5e38fa83",
    (2048, 640, 0, 256, 'bf16', 'bf16', 7): "96e0d31a5e38fa83",
    (2048, 640, 0, 256, 'bf16', 'f32', 132): "c873149644333ac8",
    (2048, 640, 0, 256, 'bf16', 'f32', 7): "c873149644333ac8",
    (1024, 400, 0, 128, 'bf16', 'bf16', 132): "39983e92e10e67bb",
    (1024, 400, 0, 128, 'bf16', 'bf16', 7): "39983e92e10e67bb",
    (1024, 400, 0, 128, 'bf16', 'f32', 132): "3e637e5e3f0195bb",
    (1024, 400, 0, 128, 'bf16', 'f32', 7): "3e637e5e3f0195bb",
    (11008, 1000, 0, 128, 'norm', 'bf16', 132): "edb343d33cd77ebf",
    (11008, 1000, 0, 128, 'norm', 'bf16', 7): "edb343d33cd77ebf",
    (11008, 1000, 0, 128, 'norm', 'f32', 132): "3ee6195cdc9e825d",
    (11008, 1000, 0, 128, 'norm', 'f32', 7): "a20350828575bc07",
    (4096, 12288, 0, 128, 'norm', 'bf16', 132): "d84da1b6ab56ff8d",
    (4096, 12288, 0, 128, 'norm', 'bf16', 7): "d84da1b6ab56ff8d",
    (4096, 12288, 0, 128, 'norm', 'f32', 132): "a8ce327df2810d76",
    (4096, 12288, 0, 128, 'norm', 'f32', 7): "81735dfbebf6abf7",
    (4096, 22528, 0, 128, 'norm', 'bf16', 132): "898da65f06d7f688",
    (4096, 22528, 0, 128, 'norm', 'bf16', 7): "898da65f06d7f688",
    (4096, 22528, 0, 128, 'norm', 'f32', 132): "bca50f7e13ec9f68",
    (4096, 22528, 0, 128, 'norm', 'f32', 7): "c3a6453a771690a9",
    (4096, 4096, 0, 128, 'f32', 'bf16', 132): "e455ed967ef17f73",
    (4096, 4096, 0, 128, 'f32', 'bf16', 7): "e455ed967ef17f73",
    (4096, 4096, 0, 128, 'f32', 'f32', 132): "9ee62d9dbdfc21e2",
    (4096, 4096, 0, 128, 'f32', 'f32', 7): "533eb8af25ea77b5",
    (11008, 4096, 0, 128, 'bf16', 'bf16', 132): "b7520dadff0fb20f",
    (11008, 4096, 0, 128, 'bf16', 'bf16', 7): "b7520dadff0fb20f",
    (11008, 4096, 0, 128, 'bf16', 'f32', 132): "cc74e1d59b139a07",
    (11008, 4096, 0, 128, 'bf16', 'f32', 7): "098d3db51968895a",
    (4096, 32000, 0, 128, 'bf16', 'bf16', 132): "10dc1174be8b553f",
    (4096, 32000, 0, 128, 'bf16', 'bf16', 7): "10dc1174be8b553f",
    (4096, 32000, 0, 128, 'bf16', 'f32', 132): "5e53100d60b22d5a",
    (4096, 32000, 0, 128, 'bf16', 'f32', 7): "7bc9e4e4ef1521a4",
}


@pytest.mark.parametrize("case", sorted(W4A8_RING_BITS))
def test_w4a8_ring_bits_unchanged(dev, case):
    """qmm_w4a8_ring's and qmm_norm_w4a8_ring's outputs are those of their
    sources before the shared ring header changed, bit for bit
    (W4A8_RING_BITS), as RING_BITS holds qmm_group_norm_ring's."""
    assert _w4a8_ring_digest(dev, case) == W4A8_RING_BITS[case]


def test_w4a8_ring_refuses_what_it_does_not_take(dev):
    """A forced ring form the inputs do not take raises, before the launch
    (two rows, an int8 weight, an f32 x with the norm) or from it (a group
    of 64 packed rows): no path falls back to another form."""
    x = _x(dev, 2, 1024)
    q = _qlin(dev, 1024, 384, 4, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    before = dict(qm.launches)
    with pytest.raises(ValueError, match="one"):
        qm._launch_w4a8(x, q, form="ring")
    with pytest.raises(ValueError, match="int4"):
        qm._launch_w4a8(x[:1], _qlin(dev, 1024, 384, 8, torch.bfloat16),
                        form="ring")
    with pytest.raises(ValueError, match="one"):
        qm._launch_w4a8(x[:1].float(), q, nw, 1e-5, form="ring")
    with pytest.raises(RuntimeError, match="launch failed"):
        qm._launch_w4a8(x[:1], _qlin(dev, 1024, 384, 4, torch.bfloat16,
                                     group=64), form="ring")
    assert dict(qm.launches) == before


# -- qmm_slab_norm and qmm_group2d at one row: their ring forms -------------
# (csrc/quant_matmul_ring.cu, over csrc/ring.cuh)

# (din, dout, pad_out): RING_CASES' shapes at group 128 (a padded dout; 260
# columns, no multiple of 16: the 4-byte copies; a partial last tile of
# 16-byte aligned rows) and the paired 7B decode's wqkv and w_gateup
SLAB_RING_CASES = [(1024, 300, 128), (1024, 260, 0), (1024, 400, 0),
                   (4096, 12288, 0), (4096, 22528, 0)]


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("din,dout,pad", SLAB_RING_CASES)
def test_slab_norm_ring_kernel(dev, din, dout, pad, sdt, monkeypatch):
    """qmm_slab_norm's one-row form against the plain version (qmm_slab_plain
    on rmsnorm_bf16's row) and the CUDA-core form, each within one bf16 ulp
    at max|plain|, at the card's SM count and at 1 and 7 SMs, bit for bit
    across two launches, the tile counters zero after; counted under
    qmm_slab_norm and qmm_slab_norm_ring."""
    q = _paired(dev, din, dout, sdt, pad_out=pad)
    x = _x(dev, 1, din) * 3 + 0.5
    nw = _norm_w(dev, din)
    want = qm.qmm_slab_plain(qm.rmsnorm_bf16(x, nw, 1e-5), q)
    old = qm._launch_slab(x, nw, q, 1e-5, "qmm_slab_norm", form="cuda_core")
    for n_sm in (_build.sms(0), 1, 7):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        before = dict(qm.launches)
        got = qm._launch_slab(x, nw, q, 1e-5, "qmm_slab_norm")
        assert qm.launches["qmm_slab_norm"] == \
            before.get("qmm_slab_norm", 0) + 1
        assert qm.launches["qmm_slab_norm_ring"] == \
            before.get("qmm_slab_norm_ring", 0) + 1
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        _within_bf16_ulp(got, want)
        _within_bf16_ulp(got, old)
        assert torch.equal(got, qm._launch_slab(x, nw, q, 1e-5,
                                                "qmm_slab_norm"))
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def _within_ulp_of(got, want):
    """Within one ulp of x's type at max|want| (bf16: 8 significant bits,
    f16: 11), an f32 output within 1e-5 of max|want|: the ring sums K in
    another order than the split's partials."""
    ref = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(want.dtype)
    limit = 1e-5 * ref if bits is None else \
        2.0 ** (math.floor(math.log2(ref)) - bits + 1)
    assert err <= limit, (err, ref, want.dtype)


# (din, dout, pad_out, kb): the split-K table's wo and w_down at 7B width
# (kb 256 and 128), a padded dout, 260 columns (the 4-byte copies), a
# partial last tile of 16-byte aligned rows
GROUP2D_RING_CASES = [(4096, 4096, 0, 256), (11008, 4096, 0, 128),
                      (2048, 300, 128, 256), (1024, 260, 0, 128),
                      (1024, 400, 0, 256)]


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16,
                                 torch.float32])
@pytest.mark.parametrize("din,dout,pad,kb", GROUP2D_RING_CASES)
def test_group2d_ring_kernel(dev, din, dout, pad, kb, xdt, sdt, knobs,
                             monkeypatch):
    """quant_matmul at one row routed to qmm_group2d (a table entry) takes
    the ring form in one launch: against qmm_group2d_plain at the table's
    kb and the two-launch form, forced, within one ulp of x's type at
    max|plain| (f32: 1e-5 of it), in x's type, at the card's SM count and
    at 1 and 7 SMs, bit for bit across two launches, the counters zero
    after; counted under qmm_group2d and qmm_group2d_ring."""
    q = _qlin(dev, din, dout, 4, sdt, pad_out=pad)
    # bn: a TPU tile that divides the physical columns, as the route asks
    knobs(table={f"{din}:{dout}:4": {"variant": "group2d",
                                     "bn": q.out_physical, "kb": kb}})
    x = (_x(dev, 1, din) * 2).to(xdt)
    assert qm.route(x, q) == ("qmm_group2d", kb)
    want = qm.qmm_group2d_plain(x, q, kb)[:, :dout]
    old = qm._launch_group2d(x, q, kb, form="cuda_core")[:, :dout]
    _within_ulp_of(old, want)
    for n_sm in (_build.sms(0), 1, 7):
        monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
        before = dict(qm.launches)
        got = qm.quant_matmul(x, q)
        assert qm.launches["qmm_group2d"] == before.get("qmm_group2d", 0) + 1
        assert qm.launches["qmm_group2d_ring"] == \
            before.get("qmm_group2d_ring", 0) + 1
        assert got.shape == want.shape and got.dtype == xdt
        _within_ulp_of(got, want)
        _within_ulp_of(got, old)
        assert torch.equal(got, qm.quant_matmul(x, q))
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def test_slab_and_group2d_ring_routes(dev, knobs):
    """At one row the ring forms: quant_matmul_norm over a paired weight
    (qmm_slab_norm_ring), and quant_matmul under a group2d table entry
    (qmm_group2d_ring over int4, the two-launch split over int8); from
    two rows the paired weight takes the tensor-core forms
    (qmm_slab_norm_mma, qmm_slab_mma) and group2d its CUDA-core form.
    qmm_slab without the norm at one row keeps its CUDA-core form, in the
    K split where group_splits takes it."""
    qp = _paired(dev, 1024, 384, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    knobs(table={"1024:384:4": {"variant": "group2d", "bn": 128, "kb": 128},
                 "1024:384:8": {"variant": "group2d", "bn": 128, "kb": 128}})
    for rows in (1, 2):
        x = _x(dev, rows, 1024) * 2
        before = dict(qm.launches)
        _within_bf16_ulp(qm.quant_matmul_norm(x, nw, qp), qm.qmm_slab_plain(
            qm.rmsnorm_bf16(x, nw, 1e-5), qp))
        _close(qm.quant_matmul(x, qp), qm.qmm_slab_plain(x, qp))
        assert qm.launches["qmm_slab_norm_ring"] == \
            before.get("qmm_slab_norm_ring", 0) + (rows == 1)
        assert qm.launches["qmm_slab_norm"] == \
            before.get("qmm_slab_norm", 0) + 1
        for name in ("qmm_slab_norm_mma", "qmm_slab_mma"):
            assert qm.launches[name] == before.get(name, 0) + (rows == 2)
        split = rows == 1 and qm.group_splits(
            rows, 384, 512, 128, _build.sms(0)) > 1
        assert qm.launches["qmm_slab_split"] == \
            before.get("qmm_slab_split", 0) + split
        for bits in (4, 8):
            q = _qlin(dev, 1024, 384, bits, torch.bfloat16)
            before = dict(qm.launches)
            _close(qm.quant_matmul(x, q), qm.qmm_group2d_plain(x, q, 128))
            assert qm.launches["qmm_group2d"] == \
                before.get("qmm_group2d", 0) + 1
            assert qm.launches["qmm_group2d_ring"] == \
                before.get("qmm_group2d_ring", 0) + (rows == 1 and bits == 4)


def test_rings_back_to_back_in_a_cuda_graph(dev, knobs):
    """Every ring form captured back to back in one CUDA graph, each launch
    a programmatic dependent launch of the one before (qmm_group_norm_ring,
    qmm_slab_norm_ring reading its output, qmm_group2d_ring reading that,
    qmm_norm_w4a8_ring, qmm_w4a8_ring): replays with new x equal the eager
    launches bit for bit and the plain versions within one bf16 ulp, and
    the tile counters they share stay zero between replays."""
    qg = _qlin(dev, 4096, 4096, 4, torch.bfloat16)
    qp = _paired(dev, 4096, 4096, torch.bfloat16, seed=3)
    q2 = _qlin(dev, 4096, 1000, 4, torch.float32, pad_out=128, seed=5)
    nw = _norm_w(dev, 4096, seed=4)
    knobs(table={"4096:1000:4": {"variant": "group2d", "bn": 128,
                                 "kb": 256}})
    x = _x(dev, 1, 4096) * 3

    def call():
        a = qm.quant_matmul_norm(x, nw, qg)
        b = qm.quant_matmul_norm(a * 4, nw, qp)
        c = qm.quant_matmul(b, q2)
        d = qm._launch_w4a8(x, qg, nw, 1e-5)
        e = qm._launch_w4a8(a, qg)
        return a, b, c, d, e

    call()                                 # build, load, counters outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(qm.launches)
    with torch.cuda.graph(graph):
        out = call()
    for name in ("qmm_group_norm_ring", "qmm_slab_norm_ring",
                 "qmm_group2d_ring", "qmm_norm_w4a8_ring", "qmm_w4a8_ring"):
        assert qm.launches[name] == before.get(name, 0) + 1
    for seed in (3, 4, 5):
        x.copy_(_x(dev, 1, 4096, seed=seed) * 3)
        graph.replay()
        torch.cuda.synchronize()
        a, b, c, d, e = out
        _within_bf16_ulp(a, qm.qmm_group_plain(qm.rmsnorm_bf16(x, nw, 1e-5),
                                               qg))
        _within_bf16_ulp(b, qm.qmm_slab_plain(
            qm.rmsnorm_bf16(a * 4, nw, 1e-5), qp))
        _within_bf16_ulp(c, qm.qmm_group2d_plain(b, q2, 256)[:, :1000])
        _within_bf16_ulp(d, qm.qmm_norm_w4a8_plain(x, nw, qg, 1e-5))
        _within_bf16_ulp(e, qm.qmm_w4a8_plain(a, qg))
        for got, want in zip(out, call()):
            assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def test_slab_norm_and_group2d_rings_on_two_streams(dev, knobs):
    """Both new ring forms on two streams at once, each stream with its
    own tile counters: every output equals the same call made alone, bit
    for bit, and the counters are zero after."""
    qp = _paired(dev, 4096, 1024, torch.bfloat16)
    q2 = _qlin(dev, 4096, 1024, 4, torch.bfloat16, seed=2)
    knobs(table={"4096:1024:4": {"variant": "group2d", "bn": 128,
                                 "kb": 256}})
    nw = _norm_w(dev, 4096, seed=5)
    xs = [_x(dev, 1, 4096, seed=s) * 2 for s in range(8)]

    def call(x):
        return qm.quant_matmul(qm.quant_matmul_norm(x, nw, qp)
                               .repeat(1, 4), q2)

    want = [call(x) for x in xs]
    before = dict(qm.launches)
    streams, got = _on_two_streams(None, xs, call=call)
    for name in ("qmm_slab_norm_ring", "qmm_group2d_ring"):
        assert qm.launches[name] == before.get(name, 0) + 2 * 5 * len(xs)
    for outs in got:
        for j, out in enumerate(outs):
            assert torch.equal(out, want[j % len(xs)])
    assert not any(c.any() for _, c in qm._COUNTERS.values())


def test_slab_norm_and_group2d_rings_refuse_what_they_do_not_take(dev):
    """A forced ring form the inputs do not take raises, before the launch
    (two rows, an unpaired weight for the slab ring, a paired or int8 one
    for qmm_group2d's, an f32 x with the norm) or from it (a group of 64
    packed rows): no path falls back to another form."""
    x = _x(dev, 2, 1024)
    qp = _paired(dev, 1024, 384, torch.bfloat16)
    q = _qlin(dev, 1024, 384, 4, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    before = dict(qm.launches)
    with pytest.raises(ValueError, match="one"):
        qm._launch_slab(x, nw, qp, 1e-5, "qmm_slab_norm", form="ring")
    with pytest.raises(ValueError, match="paired"):
        qm._launch_slab(x[:1], nw, q, 1e-5, "qmm_slab_norm", form="ring")
    with pytest.raises(ValueError, match="one"):
        qm._launch_slab(x[:1].float(), nw, qp, 1e-5, "qmm_slab_norm",
                        form="ring")
    with pytest.raises(ValueError, match="one"):
        qm._launch_group2d(x, q, 128, form="ring")
    with pytest.raises(ValueError, match="unpaired int4"):
        qm._launch_group2d(x[:1], qp, 128, form="ring")
    with pytest.raises(ValueError, match="unpaired int4"):
        qm._launch_group2d(x[:1], _qlin(dev, 1024, 384, 8, torch.bfloat16),
                           128, form="ring")
    with pytest.raises(RuntimeError, match="launch failed"):
        qm._launch_group2d(x[:1], _qlin(dev, 1024, 384, 4, torch.bfloat16,
                                        group=64), 128, form="ring")
    assert dict(qm.launches) == before


def test_slab_norm_and_group2d_ring_step_launch_counts(dev, knobs):
    """One eager decode step at batch 1 of a small model, as phases 8 and
    11 of chip_smoke.py count it: paired weights launch qmm_slab_norm 2 L
    times, all qmm_slab_norm_ring, and qmm_slab 2 L + 1 (no qmm_group*);
    a split-K table for wo and w_down launches qmm_group2d 2 L + 1 times
    (the lm_head shares wo's key), all qmm_group2d_ring."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, intermediate=1024, max_seq=128)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = llama.init_llama_params(cfg, gen, device=dev)
    tok = torch.tensor([3], dtype=torch.int32, device=dev)
    pos = torch.tensor([5], dtype=torch.int32, device=dev)
    merges = att.merge_launches(L, 1, cfg.n_kv_heads, cfg.max_seq)

    def step(params):
        qm.launches.clear()
        att.launches.clear()
        logits, _ = llama.llama_decode_step(
            params, cfg, tok, pos,
            llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev))
        torch.cuda.synchronize()
        assert torch.isfinite(logits.float()).all()
        return {k: v for k, v in {**qm.launches, **att.launches}.items()
                if v}

    paired = llama.quantize_llama_params(raw, bits=4, group_size=128,
                                         paired=True)
    got = step(paired)
    assert got["qmm_slab_norm"] == got["qmm_slab_norm_ring"] == 2 * L
    assert got["qmm_slab"] == 2 * L + 1
    assert not [k for k in got if k.startswith("qmm_group")]
    knobs(table={"512:512:4": {"variant": "group2d", "bn": 128, "kb": 128},
                 "1024:512:4": {"variant": "group2d", "bn": 128, "kb": 256}})
    got = step(llama.quantize_llama_params(raw, bits=4, group_size=128))
    assert got == {"qmm_group_norm": 2 * L, "qmm_group_norm_ring": 2 * L,
                   "qmm_group2d": 2 * L + 1, "qmm_group2d_ring": 2 * L + 1,
                   "flash_decode_q8": L, **merges}


# -- the graph corpus on the card --------------------------------------------
# Every case of tests/test_torch_graph.py's test_graph_matches_jax, built
# once through the port's GraphHandler and run by GraphExecutor on the card
# (eager, and captured in a CUDA graph as it runs by default) against the
# same graph on the CPU. Tolerance per case (GRAPH_TOL, relative to
# max|CPU| plus 1e-6): 1e-4 for f32 (TF32 off for matmuls and
# convolutions, as on the CPU; sums in another order, the card's exp / log
# a few ulps apart), 2e-3 for the cases whose sums are longer
# (LOOSE_CASES, as against JAX); integer, bool and shape outputs exact.

from torch_graph_cases import CASES, LOOSE_CASES  # noqa: E402

GRAPH_TOL = {n: 2e-3 if n in LOOSE_CASES else 1e-4 for n in CASES}


@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_corpus_on_the_card(dev, name, captured, monkeypatch):
    from infinitensor_tpu_torch.core.handler import GraphHandler
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    h = GraphHandler()
    feeds = CASES[name](h, np.random.default_rng(0))
    h.graph.infer_output_roles()
    want = GraphExecutor(h.graph, device="cpu").run(feeds, return_numpy=True)
    got = GraphExecutor(h.graph, device=dev, use_cuda_graph=captured).run(
        feeds, return_numpy=True)
    outs = [t.name for t in h.graph.outputs()]
    assert outs
    tol = GRAPH_TOL[name]
    for n in outs:
        w, g = np.asarray(want[n]), np.asarray(got[n])
        assert g.shape == w.shape and g.dtype == w.dtype, n
        if w.dtype.kind in "fc" or w.dtype.name == "bfloat16":
            w, g = w.astype(np.float64), g.astype(np.float64)
            fin = np.isfinite(w)
            assert (np.isfinite(g) == fin).all(), n
            scale = np.abs(w[fin]).max() if fin.any() else 0.0
            assert np.abs(g[fin] - w[fin]).max(initial=0.0) <= \
                tol * scale + 1e-6, n
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


# -- the paged decode's ring form (csrc/paged_flash_decode_ring.cu) --------

RING_TYPES = [(torch.bfloat16, False), (torch.float16, False),
              (torch.float32, False), (torch.bfloat16, True)]


def _paged_fns(q8):
    """(name, wrapper, plain version) of the paged kernel over INT8 pages
    (q8) or pages of q's dtype."""
    if q8:
        return ("paged_flash_decode_q8", pa.paged_flash_decode_q8,
                pa.paged_decode_q8_plain)
    return "paged_flash_decode", pa.paged_flash_decode, pa.paged_decode_plain


def _close_as(got, want):
    """The tolerance of q's dtype: 1e-5 of max|plain| in f32, else TOL."""
    if got.dtype == torch.float32:
        _close_f32(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("qdt,q8", RING_TYPES)
@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
def test_paged_ring_kernel(dev, rep, P, qdt, q8):
    """The route's ring form (one page a chunk at these shapes: every
    chunk past a slot's pos empty) against the plain version, NaN in
    every dead page and row and none in the output; the block form,
    forced, agrees."""
    name, fn, plain = _paged_fns(q8)
    args = _paged_case(dev, rep, P, q8, 300 + rep + P, B=5, qdt=qdt)
    assert pa.paged_form(qdt, args[1].dtype, args[0].shape[-1]) == "ring"
    before = dict(pa.launches)
    got = fn(*args)
    for k in (name, name + "_ring"):
        assert pa.launches[k] == before.get(k, 0) + 1
    assert pa.launches[name + "_any"] == before.get(name + "_any", 0)
    assert torch.isfinite(got.float()).all()
    want = plain(*args)
    _close_as(got, want)
    block = fn(*args, _form="block")
    assert pa.launches[name + "_ring"] == before.get(name + "_ring", 0) + 1
    assert torch.isfinite(block.float()).all()
    _close_as(block, want)


@pytest.mark.parametrize("chunk_pages", [1, 2, 4, 6])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("q8", [False, True])
def test_paged_ring_chunk_sizes(dev, q8, D, chunk_pages):
    """Every chunk size from one page to the whole table (one chunk,
    written without partials), at both head dims."""
    name, fn, plain = _paged_fns(q8)
    args = _paged_case(dev, 4, 16, q8, 40 + chunk_pages + D, D=D)
    got = fn(*args, _chunk_pages=chunk_pages)
    assert torch.isfinite(got.float()).all()
    _close(got, plain(*args))


@pytest.mark.parametrize("q8", [False, True])
def test_paged_ring_in_a_cuda_graph(dev, q8):
    """One captured launch replayed while pos crosses chunk edges (one
    16-row page a chunk): each replay equals the eager launch at that pos
    bit for bit, and a second replay gives the same bits."""
    name, fn, plain = _paged_fns(q8)
    args = list(_paged_case(dev, 4, 16, q8, 91, B=5))
    # rows past the case's pos hold NaN; make them finite, as pos moves on
    args = [torch.nan_to_num(a, nan=0.25) if a.is_floating_point() else a
            for a in args]
    pos = torch.tensor([13, 14, 29, 44, 60], dtype=torch.int32, device=dev)
    args[-1] = pos
    fn(*args)                               # warm-up: build, smem grant
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for step in range(5):                   # crosses 16, 32, 48 and 64
        pos.copy_(torch.tensor([13, 14, 29, 44, 60], dtype=torch.int32,
                               device=dev) + step)
        graph.replay()
        first = out.clone()
        graph.replay()
        assert torch.equal(out, first)
        eager = fn(*args)
        assert torch.equal(out, eager)
        _close(out, plain(*args))
    del graph


def test_paged_ring_refuses_what_it_does_not_take(dev):
    """A forced form the inputs do not take raises: the ring form for a q
    dtype other than the pages', the any-type form for what the fast
    kernels take, a form by another name; as does a chunk size giving
    more than MAX_CHUNKS chunks."""
    args = _paged_case(dev, 2, 16, False, 5, B=3)
    q, kp, vp, table, pos = args
    with pytest.raises(ValueError):
        pa.paged_flash_decode(q.half(), kp, vp, table, pos, _form="ring")
    for form in ("any", "warp"):
        with pytest.raises(ValueError):
            pa.paged_flash_decode(*args, _form=form)
    wide = table.repeat(1, pa.MAX_CHUNKS // table.shape[1] + 1)
    with pytest.raises(ValueError):
        pa.paged_flash_decode(q, kp, vp, wide.contiguous(), pos,
                              _chunk_pages=1)


# -- the paired tensor-core form (qmm_slab_mma, qmm_slab_norm_mma) -----------

SLAB_MMA_SHAPES = [(1024, 300, 128), (1024, 260, 0), (768, 256, 0)]


@pytest.mark.parametrize("rows", [2, 3, 8, 17, 64, 256])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_slab_mma_kernel(dev, rows, xdt, sdt, monkeypatch):
    """qmm_slab's tensor-core form (and, for a bf16 x, qmm_slab_norm's)
    against the plain version and against the CUDA-core body, both
    forced, at a padded dout, a dout with no multiple of 16 columns (its
    4-byte copies) and three packed groups (din 768), with K split (the
    card's SM count) and not split (one SM), bit for bit across two
    launches; counted under qmm_slab(_norm) and again under
    qmm_slab(_norm)_mma."""
    nw = _norm_w(dev, 1024)
    sms = _build.sms(0)
    for din, dout, pad in SLAB_MMA_SHAPES:
        q = _paired(dev, din, dout, sdt, pad_out=pad)
        x = (_x(dev, rows, din, seed=rows) * 3 + 0.5).to(xdt)
        norms = [None] + ([nw[:din].contiguous()]
                          if xdt == torch.bfloat16 else [])
        for n_sm in (sms, 1):
            monkeypatch.setattr(_build, "sms", lambda i, n=n_sm: n)
            for norm_w in norms:
                name = "qmm_slab" if norm_w is None else "qmm_slab_norm"
                want = qm.qmm_slab_plain(
                    x if norm_w is None
                    else qm.rmsnorm_bf16(x, norm_w, 1e-5), q)
                before = dict(qm.launches)
                got = qm._launch_slab(x, norm_w, q, 1e-5, name, form="mma")
                assert qm.launches[name] == before.get(name, 0) + 1
                assert qm.launches[name + "_mma"] == \
                    before.get(name + "_mma", 0) + 1
                assert got.dtype == xdt
                _close(got, want)
                _close(got, qm._launch_slab(x, norm_w, q, 1e-5, name,
                                            form="cuda_core"))
                assert torch.equal(got, qm._launch_slab(
                    x, norm_w, q, 1e-5, name, form="mma"))


@pytest.mark.parametrize("rows", [2, 8, 64])
def test_slab_mma_in_a_cuda_graph(dev, rows):
    """Both paired tensor-core forms captured in one CUDA graph: replays
    equal the eager launches bit for bit, also after x changes in place."""
    q = _paired(dev, 2048, 640, torch.bfloat16)
    x = _x(dev, rows, 2048) * 3
    nw = _norm_w(dev, 2048)

    def both():
        return qm.quant_matmul(x, q), qm.quant_matmul_norm(x, nw, q)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(qm.launches)
    with torch.cuda.graph(graph):
        outs = both()
    for name in ("qmm_slab_mma", "qmm_slab_norm_mma"):
        assert qm.launches[name] == before.get(name, 0) + 1
    for seed in (1, 2):
        x.copy_(_x(dev, rows, 2048, seed=seed) * 3)
        graph.replay()
        torch.cuda.synchronize()
        again = both()
        for out, eager in zip(outs, again):
            assert torch.equal(out, eager)
        _close(outs[0], qm.qmm_slab_plain(x, q)[:, :640])
        _close(outs[1], qm.qmm_slab_plain(qm.rmsnorm_bf16(x, nw, 1e-5),
                                          q)[:, :640])


def test_slab_mma_step_launch_counts(dev):
    """One eager decode step of a small paired model at 4 rows (the dense
    engine's step, as phase 8 of chip_smoke.py counts it) launches
    qmm_slab_norm 2 L times, all qmm_slab_norm_mma, and qmm_slab 2 L + 1,
    all qmm_slab_mma; a 64-token prefill (the norm unfused) qmm_slab
    4 L + 1 times, all qmm_slab_mma. No qmm_group* and no ring."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, intermediate=1024, max_seq=128)
    L = cfg.n_layers
    params = llama.quantize_llama_params(
        llama.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev), bits=4, group_size=128, paired=True)
    tok = torch.tensor([3, 4, 5, 6], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, 9, 0, 40], dtype=torch.int32, device=dev)
    qm.launches.clear()
    logits, _ = llama.llama_decode_step(
        params, cfg, tok, pos,
        llama.init_kv_cache(cfg, 4, kv_quant=True, device=dev))
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    got = {k: v for k, v in qm.launches.items() if v}
    assert got == {"qmm_slab_norm": 2 * L, "qmm_slab_norm_mma": 2 * L,
                   "qmm_slab": 2 * L + 1, "qmm_slab_mma": 2 * L + 1}
    qm.launches.clear()
    prompt = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(dev)
    logits, _ = llama.llama_prefill(params, cfg, prompt,
                                    llama.init_kv_cache(cfg, 1, device=dev))
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    got = {k: v for k, v in qm.launches.items() if v}
    assert got == {"qmm_slab": 4 * L + 1, "qmm_slab_mma": 4 * L + 1}


def test_slab_mma_refuses_what_it_does_not_take(dev):
    """The paired tensor-core form, forced, raises before any launch on an
    f32 x (with the norm an f16 x too) and on an unpaired weight: no path
    falls back to the CUDA-core body."""
    x = _x(dev, 8, 1024)
    qp = _paired(dev, 1024, 384, torch.bfloat16)
    q = _qlin(dev, 1024, 384, 4, torch.bfloat16)
    nw = _norm_w(dev, 1024)
    before = dict(qm.launches)
    with pytest.raises(ValueError, match="bf16 or f16"):
        qm._launch_slab(x.float(), None, qp, 0.0, "qmm_slab", form="mma")
    with pytest.raises(ValueError, match="bf16 x"):
        qm._launch_slab(x.half(), nw, qp, 1e-5, "qmm_slab_norm", form="mma")
    for norm_w in (None, nw):
        with pytest.raises(ValueError, match="paired int4"):
            qm._launch_slab(x, norm_w, q, 1e-5, "qmm_slab", form="mma")
    assert dict(qm.launches) == before
    assert qm.slab_form(8, torch.float32, False) == "cuda_core"


# -- the band lowering's gate (ops/lowering.py G2BMM / GBMM) ------------------

@pytest.mark.parametrize("bz,m,k,w,launched", [
    (2, 64, 512, 128, False),     # f32 k 512 w 128: the window does not fit
    (65536, 4, 8, 1, False),      # bz above a launch's grid
    (2, 64, 128, 6, True),        # the ring form takes it
])
def test_band_lowering_gate_on_the_card(dev, bz, m, k, w, launched):
    """G2BMM -> GBMM through GraphHandler and GraphExecutor in f32 on the
    card: where band_kernels_usable refuses (a first-form window too wide
    for a block's shared memory, or bz above 65535) the lowering takes its
    gather or shift-scan path and launches no band kernel; where it passes
    the ring form launches once each. Within 1e-4 of max|plain| of
    g2bmm_plain / gbmm_plain either way."""
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.kernels import band
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    assert band.band_kernels_usable("g2bmm", torch.float32, torch.float32,
                                    bz, m, k, w, 1) == launched
    h = GraphHandler()
    a_in, b_in = (h.input((bz, m, k), name=n) for n in ("a", "b"))
    h.gbmm(h.g2bmm(a_in, b_in, width=w), b_in)
    h.graph.infer_output_roles()
    g = torch.Generator().manual_seed(bz + m + k + w)
    a, b = (torch.randn(bz, m, k, generator=g).to(dev) for _ in range(2))
    before = dict(band.launches)
    (out,) = GraphExecutor(h.graph, device=dev, use_cuda_graph=False).run(
        {"a": a, "b": b}).values()
    torch.cuda.synchronize()
    n = 1 if launched else 0
    assert band.launches["g2bmm"] == before.get("g2bmm", 0) + n
    assert band.launches["gbmm"] == before.get("gbmm", 0) + n
    want = band.gbmm_plain(band.g2bmm_plain(a, b, w), b, w)
    assert out.shape == want.shape and out.dtype == torch.float32
    err = (out - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


# -- the other models and the ONNX frontend (models/opt.py, bert.py, -------
# -- vision.py; onnx/*) ------------------------------------------------------

#: OPT-1.3B's four matmuls (din, dout): w_qkv, w_o, w_up, w_down
OPT_SHAPES = {"w_qkv": (2048, 6144), "w_o": (2048, 2048),
              "w_up": (2048, 8192), "w_down": (8192, 2048)}


@pytest.mark.parametrize("rows", [1, 8, 256])
@pytest.mark.parametrize("group", [128, None])
@pytest.mark.parametrize("name", list(OPT_SHAPES))
def test_group_int8_at_opt_shapes(dev, name, group, rows):
    """The int8 qmm_group at OPT-1.3B's shapes, at group 128 and at group
    None (one group of din): the K split at 1 row where group_splits
    gives one, qmm_group_mma from 2 rows; within 1e-2 of max|plain|."""
    din, dout = OPT_SHAPES[name]
    q = _qlin(dev, din, dout, 8, torch.float32, group=group or din)
    assert q.group_size == (group or din)
    x = _x(dev, rows, din, seed=rows)
    before = dict(qm.launches)
    _close(qm.quant_matmul(x, q), qm.qmm_group_plain(x, q))
    new = {k: v - before.get(k, 0) for k, v in qm.launches.items()
           if v != before.get(k, 0)}
    split = qm.group_splits(rows, q.out_physical, q.qweight.shape[0],
                            q.group_size, _build.sms(0)) > 1
    want = {"qmm_group": 1}
    if rows >= qm.MMA_MIN_ROWS:
        want["qmm_group_mma"] = 1
    elif split:
        want["qmm_group_split"] = 1
    assert new == want
    assert split == (rows == 1 and group == 128)


@pytest.mark.parametrize("B", [1, 8])
def test_flash_decode_at_opt_shape(dev, B):
    """flash_decode at OPT-1.3B's attention (32 heads of D 64, bf16 cache
    of 2048 rows): the split form and its merge at batch 1, one launch at
    batch 8; within 1e-2 of max|plain|."""
    g = torch.Generator(device=dev).manual_seed(64 + B)
    H, S, D = 32, 2048, 64
    q = torch.randn(B, H, 1, D, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(B, H, S, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.tensor([255 + 97 * i for i in range(B)], dtype=torch.int32,
                       device=dev)
    before = dict(att.launches)
    _close(att.flash_decode(q, kc, vc, pos),
           att.flash_decode_plain(q, kc, vc, pos))
    new = {k: v - before.get(k, 0) for k, v in att.launches.items()
           if v != before.get(k, 0)}
    assert new == {"flash_decode": 1,
                   **att.merge_launches(1, B, H, S)}
    assert ("flash_decode_merge" in new) == (B == 1)


def _opt_small(dtype=torch.bfloat16):
    from infinitensor_tpu_torch.models import opt
    return opt, opt.OPTConfig(vocab_size=512, dim=512, n_layers=2,
                              n_heads=8, ffn_dim=1024, max_seq=128,
                              dtype=dtype)


def test_opt_step_launches_and_logits(dev):
    """A 512-wide, 2-layer OPT (8 heads of D 64) with INT8 weights at group
    128: one eager decode step at batch 1 launches qmm_group 8 (4 a
    layer), flash_decode 2 and its merges, nothing else; its prefill of 32
    tokens 8 qmm_group_mma; the logits of both within 5e-2 of max|logit|
    of the same step on the CPU, same top-1 or a near-tie."""
    opt, cfg = _opt_small()
    params = opt.quantize_opt_params(opt.init_opt_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), 8, 128)
    on = {"wte": params["wte"].to(dev), "wpe": params["wpe"].to(dev),
          "lnf_g": params["lnf_g"].to(dev), "lnf_b": params["lnf_b"].to(dev),
          "layers": [{k: (QuantizedLinear(v.qweight.to(dev),
                                          v.scales.to(dev), v.bits,
                                          v.group_size, v.out_logical)
                          if isinstance(v, QuantizedLinear) else v.to(dev))
                      for k, v in lay.items()} for lay in params["layers"]]}
    tokens = torch.arange(3, 35, dtype=torch.int32)[None]
    outs = {}
    for d, p in (("cpu", params), (dev, on)):
        cache = opt.init_opt_cache(cfg, 1, device=d)
        for m in (qm, att):
            m.launches.clear()
        lp, cache = opt.opt_prefill(p, cfg, tokens.to(d), cache)
        pre = {k: v for m in (qm, att) for k, v in m.launches.items() if v}
        for m in (qm, att):
            m.launches.clear()
        ld, cache = opt.opt_decode_step(
            p, cfg, tokens[:, -1].to(d), torch.full((1,), 32,
                                                    dtype=torch.int32,
                                                    device=d), cache)
        torch.cuda.synchronize()
        step = {k: v for m in (qm, att) for k, v in m.launches.items() if v}
        outs[str(d)] = (lp[0, -1].float().cpu(), ld[0].float().cpu(), pre,
                        step)
    cpu, card = outs["cpu"], outs[str(dev)]
    assert cpu[2] == {} and cpu[3] == {}
    assert card[2] == {"qmm_group": 8, "qmm_group_mma": 8}
    L = cfg.n_layers
    split = sum(qm.group_splits(1, d_out, d_in, 128, _build.sms(0)) > 1
                for d_in, d_out in ((512, 1536), (512, 512), (512, 1024),
                                    (1024, 512))) * L
    assert card[3] == {"qmm_group": 4 * L, "flash_decode": L,
                       **({"qmm_group_split": split} if split else {}),
                       **att.merge_launches(L, 1, cfg.n_heads, cfg.max_seq)}
    for got, want in ((card[0], cpu[0]), (card[1], cpu[1])):
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        assert err <= 5e-2 * ref, (err, ref)
        a, b = int(got.argmax()), int(want.argmax())
        assert a == b or float(want[b] - want[a]) <= 2 * err


def test_bert_int8_layer_onnx_round_trip_bit_exact(dev):
    """A BERT-base-wide layer (768, 12 heads, B 2, S 128) as its dynamic
    INT8 graph: exported to ONNX, re-imported and run on the card (one
    captured graph) equals the directly built graph on the card bit for
    bit, and the CPU's within 1e-3 of max|h|."""
    from infinitensor_tpu_torch.models import bert
    from infinitensor_tpu_torch.onnx import OnnxStub, export_onnx
    from infinitensor_tpu_torch.runtime.runtime import (
        cpu_runtime, cuda_runtime)
    cfg = bert.BertConfig(n_layers=1)
    params = bert.init_bert_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    h = bert.build_bert_layer_graph(cfg, params["layers"][0], 2, 128,
                                    dynamic_quant=True)
    x = np.random.default_rng(0).standard_normal((2, 128, 768)).astype(
        np.float32)
    direct = list(h.run({"x": x}, return_numpy=True).values())[0]
    stub = OnnxStub(export_onnx(h.graph).serialize(), cuda_runtime())
    got = list(stub.run({"x": x}, return_numpy=True).values())[0]
    assert np.array_equal(got, direct)
    h.runtime, h._executor = cpu_runtime(), None
    want = list(h.run({"x": x}, return_numpy=True).values())[0]
    assert np.abs(direct - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("block", ["mbconv", "inception"])
def test_vision_block_onnx_round_trip(dev, block):
    """An MBConv and an Inception block re-imported from ONNX and run on
    the card equal the directly built graph on the card bit for bit, and
    the CPU's eager run within 1e-3 of max|ref| (tools/vision_parity.py's
    bound)."""
    from infinitensor_tpu_torch.core.handler import GraphHandler
    from infinitensor_tpu_torch.models import vision
    from infinitensor_tpu_torch.onnx import OnnxStub, export_onnx
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    from infinitensor_tpu_torch.runtime.runtime import cuda_runtime
    rng = np.random.default_rng(3)
    h = GraphHandler(cuda_runtime())
    if block == "mbconv":
        p = vision.init_mbconv_params(rng, cin=32, cout=32, expand=6, k=5)
        x = h.input((1, 32, 56, 56), name="input")
        vision.build_mbconv(h, x, {k: h.weight(v, name=k)
                                   for k, v in p.items()})
    else:
        p = vision.init_inception_block_params(rng, 192, 64, 96, 128, 16,
                                               32, 32)
        x = h.input((1, 192, 28, 28), name="input")
        vision.build_inception_block(h, x, {k: h.weight(v, name=k)
                                            for k, v in p.items()})
    h.graph.infer_output_roles()
    img = rng.standard_normal(x.shape).astype(np.float32)
    direct = list(h.run({"input": img}, return_numpy=True).values())[0]
    stub = OnnxStub(export_onnx(h.graph).serialize(), cuda_runtime())
    got = list(stub.run({"input": img}, return_numpy=True).values())[0]
    assert np.array_equal(got, direct)
    want = list(GraphExecutor(h.graph, device="cpu").run(
        {"input": img}, return_numpy=True).values())[0]
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("name", ["matmul_woq", "attention_kvcache"])
def test_corpus_kernel_cases_through_onnx(dev, name):
    """The corpus's kernel cases exported and re-imported, run on the card
    eagerly: the imported graph launches the same kernels as the directly
    built one (each nonzero) and gives its outputs bit for bit."""
    from infinitensor_tpu_torch.core.handler import GraphHandler
    from infinitensor_tpu_torch.onnx import OnnxStub, export_onnx
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    from infinitensor_tpu_torch.runtime.runtime import cuda_runtime
    h = GraphHandler(cuda_runtime())
    feeds = CASES[name](h, np.random.default_rng(0))
    h.graph.infer_output_roles()
    stub = OnnxStub(export_onnx(h.graph).serialize(), cuda_runtime())
    runs = {}
    for label, graph in (("direct", h.graph), ("onnx", stub.handler.graph)):
        for m in (qm, att):
            m.launches.clear()
        out = GraphExecutor(graph, device=dev, use_cuda_graph=False).run(
            feeds, return_numpy=True)
        torch.cuda.synchronize()
        runs[label] = (out, {k: v for m in (qm, att)
                             for k, v in m.launches.items() if v})
    (d_out, d_n), (o_out, o_n) = runs["direct"], runs["onnx"]
    assert d_n == o_n and d_n
    kernel = "qmm_group" if name == "matmul_woq" else "flash_decode"
    assert d_n.get(kernel, 0) > 0
    assert set(d_out) == set(o_out)
    for k in d_out:
        assert np.array_equal(np.asarray(o_out[k]), np.asarray(d_out[k])), k


# -- the optimizer and the tuner on the card (optimizer/search.py, ---------
# -- runtime/tuner.py, runtime/profiling.py) ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_picks_the_band_form_on_the_card(dev, dtype):
    """The masked S x S attention in standard ops (bz 4, S 2048, D 64, w
    32), searched on the card with a fresh PerfEngine: the winner holds
    G2BMM and GBMM, one eager run launches both rings once, and its output
    is within 1e-4 (f32) / 4e-2 (bf16) of max|f64 dense attention|."""
    import ml_dtypes
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.kernels import band
    from infinitensor_tpu_torch.optimizer.search import SearchEngine
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    bz, S, D, w = 4, 2048, 64, 32
    i = np.arange(S)
    mask = np.where(np.abs(i[:, None] - i[None, :]) <= w, np.float32(0),
                    np.float32(-1e9))
    if dtype == "bfloat16":
        mask = mask.astype(ml_dtypes.bfloat16)
    h = GraphHandler()
    q, k, v = (h.input((bz, S, D), dtype=dtype, name=n) for n in "qkv")
    scores = h.matmul(q, h.transpose(k, perm=[0, 2, 1]))
    h.matmul(h.softmax(h.add(scores, h.weight(mask)), axis=-1), v)
    h.graph.infer_output_roles()
    win = SearchEngine(perf=PerfEngine(), device=dev).run(h.graph)
    assert {"G2BMM", "GBMM"} <= {op.op_type for op in win.operators}
    g = torch.Generator().manual_seed(23)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    feeds = {n: (torch.randn(bz, S, D, generator=g) * 0.5).to(tdt).to(dev)
             for n in "qkv"}
    before = dict(band.launches)
    (out,) = GraphExecutor(win, device=dev, use_cuda_graph=False).run(
        feeds).values()
    torch.cuda.synchronize()
    for name in ("g2bmm_ring", "gbmm_ring"):
        assert band.launches[name] == before.get(name, 0) + 1, name
    qd, kd, vd = (feeds[n].double() for n in "qkv")
    idx = torch.arange(S, device=dev)
    sc = torch.where((idx[:, None] - idx[None, :]).abs() <= w,
                     qd @ kd.transpose(1, 2), -math.inf)
    ref = torch.softmax(sc, -1) @ vd
    assert out.dtype == tdt
    err = (out.double() - ref).abs().max().item()
    tol = 1e-4 if dtype == "float32" else 4e-2
    assert err <= tol * ref.abs().max().item(), err


def test_tuned_sweeps_against_the_default_launch(dev):
    """tuned_flash_decode(_q8) and tuned_quant_matmul at one row on the
    card: every candidate runs, the tuned output is within TOL of the
    default launch's and of the kernel's plain version, and a second call
    times nothing."""
    from infinitensor_tpu_torch.runtime import tuner
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    g = torch.Generator().manual_seed(24)
    B, H, S, D = 1, 8, 1024, 128
    pos = torch.full((B,), 700, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).to(dev)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    ks, vs = ((torch.rand(B, H, S, generator=g) * 0.01 + 0.005).to(dev)
              for _ in range(2))
    q = randn(B, H, 1, D)
    cases = [(tuner.tuned_flash_decode, att.flash_decode,
              att.flash_decode_plain, "flash_decode",
              (q, randn(B, H, S, D), randn(B, H, S, D), pos)),
             (tuner.tuned_flash_decode_q8, att.flash_decode_q8,
              att.flash_decode_q8_plain, "flash_decode_q8",
              (q, int8(B, H, S, D), int8(B, H, S, D), ks, vs, pos)),
             (tuner.tuned_quant_matmul, qm.quant_matmul,
              lambda x, w: qm.qmm_group_plain(x, w)[:, :w.out_features],
              "quant_matmul", (_x(dev, 1, 4096),
                               _qlin(dev, 4096, 4096, 4, torch.bfloat16)))]
    pe, timed = PerfEngine(), []
    time_call = tuner._time_call
    try:
        tuner._time_call = lambda *a: timed.append(1) or time_call(*a)
        for tuned, default, plain, name, args in cases:
            got = tuned(*args, perf_engine=pe)
            _close(got, default(*args))
            _close(got, plain(*args))
            rec = tuner.record(name, args, pe)
            assert rec["skipped"] == [] and len(rec["candidates"]) > 1
        n = len(timed)
        for tuned, default, plain, name, args in cases:
            tuned(*args, perf_engine=pe)
        assert len(timed) == n
    finally:
        tuner._time_call = time_call


def test_timeit_times_the_card_with_cuda_events(dev, monkeypatch):
    """profiling.timeit on CUDA outputs records CUDA events, and reads
    about what the events around the same calls read."""
    from infinitensor_tpu_torch.runtime import profiling
    made = []
    real = torch.cuda.Event

    def event(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", event)
    a = torch.randn(2048, 2048, device=dev)
    ms = profiling.timeit(lambda x: x @ x, a, warmup=2, rounds=10)
    assert len(made) == 2 and ms > 0.0
    e0, e1 = real(enable_timing=True), real(enable_timing=True)
    e0.record()
    for _ in range(10):
        a @ a
    e1.record()
    e1.synchronize()
    assert 0.5 < ms / (e0.elapsed_time(e1) / 10) < 2.0


def test_captured_ms_cycles_cold_copies(dev):
    """profiling.captured_ms copies the operands until the copies hold
    COLD_L2_TIMES times the L2, captures one call a copy in turn, and
    reads a positive time; the caller's tensors are not written."""
    from infinitensor_tpu_torch.runtime import profiling
    a = torch.randn(1024, 1024, device=dev)       # 4 MiB
    keep = a.clone()
    seen = set()

    def fn(x):
        seen.add(x.data_ptr())
        return x @ x

    ms = profiling.captured_ms(fn, (a,), warmup=1, iters=5)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    n = min(profiling.MAX_COPIES,
            -(-profiling.COLD_L2_TIMES * l2 // (a.numel() * 4)))
    assert len(seen) == n and ms > 0.0
    assert torch.equal(a, keep)


# -- nnet/*: the evaluator, MemBound and NMutator on the card ---------------

def _nnet_comps():
    """Comprehensions of tests/test_torch_nnet.py's kinds (no jax here): a
    padded, strided, dilated conv; every Func; /, //, % on index grids
    through a padded access; unpadded reads out of range at both ends and
    at negative indices, alone and summed."""
    from infinitensor_tpu_torch.nnet import derivation
    from infinitensor_tpu_torch.nnet.expr import (
        Comprehension, Func, TensorRef, fresh_var)
    out = {"conv": derivation.conv_expr(2, 3, 9, 9, 4, 3, 3, pad=3,
                                        stride=2, dilation=2),
           "matmul": derivation.matmul_expr(7, 12, 5, True, True)}
    for fn in ("relu", "tanh", "exp", "sigmoid"):
        i, j = fresh_var("i"), fresh_var("j")
        X = TensorRef("X", (5, 7))
        out[fn] = Comprehension([(i, 5), (j, 7)], [],
                                Func(fn, X[i, j] * 0.5 + 0.25))
    i, j = fresh_var("i"), fresh_var("j")
    X = TensorRef("X", (6, 8), paddings=(2, 2))
    out["index_math"] = Comprehension(
        [(i, 6), (j, 8)], [],
        X[(i - 3) // 2 + 1, (j - 5) % 4 + j // -3] + (i - 2) / 4.0)
    i, j = fresh_var("i"), fresh_var("j")
    X = TensorRef("X", (5, 4))
    out["out_of_range"] = Comprehension(
        [(i, 9), (j, 7)], [], X[i * 2 - 8, j - 3] + X[-1, j + 9] * X[i, -6])
    i, k = fresh_var("i"), fresh_var("k")
    X = TensorRef("X", (4, 6))
    out["summed_oob"] = Comprehension([(i, 5)], [(k, 9)],
                                      X[i - 1, k - 2] * (k - 4))
    return out


@pytest.mark.parametrize("budget", [None, 64])
def test_nnet_evaluator_on_the_card(dev, budget, monkeypatch):
    """Every comprehension on the card within 1e-5 of max|CPU| (f32, sums
    in another order), whole and in chunks of 64 grid elements."""
    from infinitensor_tpu_torch.nnet import evaluator
    for name, comp in _nnet_comps().items():
        rng = np.random.default_rng(0)
        feeds = {t.name: rng.standard_normal(t.shape).astype(np.float32)
                 for t in comp.inputs()}
        want = evaluator.evaluate(comp, feeds, device="cpu")
        if budget is not None:
            monkeypatch.setattr(evaluator, "ELEMENT_BUDGET", budget)
        got = evaluator.evaluate(comp, feeds, device=dev)
        monkeypatch.undo()
        assert got.is_cuda and got.dtype == want.dtype, name
        err = (got.cpu().double() - want.double()).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (name, err)


def _membound_graph(comp, x_shape):
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.core import dtype
    h = GraphHandler()
    x = h.input(x_shape, name="x")
    h._add("MemBound", [x], {"expr": comp,
                             "out_specs": [(comp.shape, dtype.FLOAT32)]})
    h.graph.infer_output_roles()
    return h.graph


def test_membound_out_of_range_captured(dev):
    """An unpadded MemBound reading out of range at both ends and at
    negative indices, captured and replayed on new inputs: the CPU's
    values (JAX's wrap-then-clamp rule), no device-side assert, and the
    card still runs after it."""
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    g = _membound_graph(_nnet_comps()["out_of_range"], (5, 4))
    ex = GraphExecutor(g, device=dev)
    assert ex.use_cuda_graph
    for seed in (0, 1):
        feeds = {"x": np.random.default_rng(seed).standard_normal(
            (5, 4)).astype(np.float32)}
        want = GraphExecutor(g, device="cpu").run(feeds, return_numpy=True)
        got = ex.run(feeds, return_numpy=True)
        torch.cuda.synchronize()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert (torch.ones(4, device=dev) * 2).sum().item() == 8.0


def test_nmutator_mutant_captured_against_conv(dev, monkeypatch):
    """NMutator on the card (its oracle there) derives the im2col mutant
    (MatMul + MemBound) of a padded, strided, dilated conv + relu; run
    captured, it is within 1e-4 of max|base| of the Conv graph's
    output."""
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.nnet import NMutator
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(5)
    h = GraphHandler()
    x = h.input((2, 16, 20, 20), name="x")
    w = h.weight((rng.standard_normal((32, 16, 3, 3)) / 12).astype(
        np.float32), name="W")
    h.relu(h.conv(x, w, pads=(2, 2), strides=(2, 2), dilations=(2, 2)))
    h.graph.infer_output_roles()
    muts = NMutator(device=dev).run(h.graph)
    im2col = [m for m in muts
              if {"MatMul", "MemBound"} <= {op.op_type for op in m.operators}]
    assert im2col
    feeds = {"x": torch.from_numpy(rng.standard_normal(
        (2, 16, 20, 20)).astype(np.float32)).to(dev)}
    (want,) = GraphExecutor(h.graph, device=dev).run(feeds).values()
    for m in im2col:
        (got,) = GraphExecutor(m, device=dev).run(feeds).values()
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
