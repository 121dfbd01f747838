"""The port's paged KV machinery against the JAX package on the same
numpy inputs: the plain versions of the two paged kernels against the
Pallas kernels in interpret mode, the appends and the prefill scatter bit
for bit, the page allocator, and a paged decode step of a small INT4
Llama.

The kernel comparison's tolerance is one bf16 ulp of max|want| (both
sides sum in f32 in another order and round once to bf16). The ring
form's plain first step (page-chunk partials) merged by
flash_decode_merge_plain is held to the same tolerance. The model
comparison holds the tolerance tests/test_torch_llama.py states: logits
within 3e-2 of max|logit|, argmax equal. There the JAX side (under
pallas_interpret=True on the CPU) runs rmsnorm + dequantize + matmul for
every projection of the paged block and the interpreted paged kernel; the
port runs the plain "group" matmul and the plain paged decode.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.kernels import paged_attention as jpa
from infinitensor_tpu.models import llama as jl
from infinitensor_tpu.serving import paged_cache as jpc
from infinitensor_tpu.serving.paged_engine import (
    scatter_prefill_into_pages as j_scatter)
from infinitensor_tpu.utils.config import config

from infinitensor_tpu_torch.kernels import attention as tatt
from infinitensor_tpu_torch.kernels import paged_attention as tpa
from infinitensor_tpu_torch.models import llama as tl
from infinitensor_tpu_torch.models.convert import (
    paged_cache_from_jax_numpy, params_from_jax_numpy)
from infinitensor_tpu_torch.serving import paged_cache as tpc
from infinitensor_tpu_torch.serving.paged_engine import (
    scatter_prefill_into_pages as t_scatter)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _case(P, rep, q8, seed):
    """A pool with spare pages, a shuffled table, and ragged pos with 0,
    both sides of a page boundary and the last row."""
    rng = np.random.default_rng(seed)
    B, Hkv, D, MP = 4, 2, 32, 3
    N = B * MP + 2
    table = (rng.permutation(N - 1)[:B * MP] + 1).reshape(B, MP).astype(
        np.int32)
    pos = np.asarray([0, P - 1, P, MP * P - 1], np.int32)
    q = rng.standard_normal((B, Hkv * rep, 1, D)).astype(np.float32)
    if q8:
        kp, vp = (rng.integers(-127, 128, (N, Hkv, P, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (N, Hkv, P)).astype(np.float32)
                  for _ in range(2))
        return q, kp, vp, ks, vs, table, pos
    kp, vp = (rng.standard_normal((N, Hkv, P, D)).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, None, None, table, pos


def _one_ulp(want: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("P", [8, 16])
def test_paged_decode_plain_matches_interpreted_kernel(P, rep):
    q, kp, vp, _, _, table, pos = _case(P, rep, False, 10 * P + rep)
    want = _f32(jpa.paged_flash_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(pos),
        interpret=True))
    args = (_bf16(q), _bf16(kp), _bf16(vp), torch.from_numpy(table),
            torch.from_numpy(pos))
    got = tpa.paged_decode_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(_f32(got) - want).max() <= _one_ulp(want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(tpa.paged_flash_decode(*args), got)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("P", [8, 16])
def test_paged_decode_q8_plain_matches_interpreted_kernel(P, rep):
    q, kp, vp, ks, vs, table, pos = _case(P, rep, True, 20 * P + rep)
    want = _f32(jpa.paged_flash_decode_q8(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(table),
        jnp.asarray(pos), interpret=True))
    args = (_bf16(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(table), torch.from_numpy(pos))
    got = tpa.paged_decode_q8_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(_f32(got) - want).max() <= _one_ulp(want)
    assert torch.equal(tpa.paged_flash_decode_q8(*args), got)


@pytest.mark.parametrize("q8", [False, True])
def test_plain_versions_never_read_dead_rows(q8):
    """NaN in every row no slot owns or past its pos changes nothing."""
    q, kp, vp, ks, vs, table, pos = _case(8, 2, q8, 5)
    B, MP, P = table.shape[0], table.shape[1], 8
    live = np.zeros((kp.shape[0], P), bool)
    for b in range(B):
        for s in range(pos[b] + 1):
            live[table[b, s // P], s % P] = True
    dead = np.broadcast_to(~live[:, None, :], kp.shape[:3])
    t = torch.from_numpy
    if q8:
        args = [_bf16(q), t(kp), t(vp), t(ks), t(vs), t(table), t(pos)]
        want = tpa.paged_decode_q8_plain(*args)
        args[3], args[4] = t(np.where(dead, np.nan, ks).astype(np.float32)), \
            t(np.where(dead, np.nan, vs).astype(np.float32))
        got = tpa.paged_decode_q8_plain(*args)
    else:
        args = [_bf16(q), _bf16(kp), _bf16(vp), t(table), t(pos)]
        want = tpa.paged_decode_plain(*args)
        args[1] = _bf16(np.where(dead[..., None], np.nan, kp))
        args[2] = _bf16(np.where(dead[..., None], np.nan, vp))
        got = tpa.paged_decode_plain(*args)
    assert torch.isfinite(got.float()).all() and torch.equal(got, want)


def _merged(part) -> torch.Tensor:
    """The ring form's second step, plain, rounded to bf16 as the kernel
    writes q's dtype."""
    return tatt.flash_decode_merge_plain(part).to(torch.bfloat16)


def _split_args(q, kp, vp, ks, vs, table, pos):
    if ks is None:
        return (_bf16(q), _bf16(kp), _bf16(vp), torch.from_numpy(table),
                torch.from_numpy(pos))
    return (_bf16(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(table), torch.from_numpy(pos))


def _split(args, chunk_pages):
    fn = tpa.paged_decode_split_plain if len(args) == 5 \
        else tpa.paged_decode_q8_split_plain
    return fn(*args, chunk_pages)


@pytest.mark.parametrize("chunk_pages", [1, 2])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("P", [8, 16])
def test_paged_split_plain_matches_interpreted_kernel(P, rep, q8,
                                                      chunk_pages):
    """The ring form's chunks, merged, against the Pallas kernel: pos 0
    (every later chunk empty), P - 1 and P (both sides of a one-page chunk
    edge), the last row of the table."""
    q, kp, vp, ks, vs, table, pos = _case(P, rep, q8, 30 * P + rep + 7 * q8)
    if q8:
        want = jpa.paged_flash_decode_q8(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(table),
            jnp.asarray(pos), interpret=True)
    else:
        want = jpa.paged_flash_decode(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
            jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table),
            jnp.asarray(pos), interpret=True)
    want = _f32(want)
    args = _split_args(q, kp, vp, ks, vs, table, pos)
    part = _split(args, chunk_pages)
    MP = table.shape[1]
    chunks = -(-MP // chunk_pages)
    B, H, D = q.shape[0], q.shape[1], q.shape[3]
    assert part.dtype == torch.float32
    assert tuple(part.shape) == (B, H, chunks, D + 2)
    # a chunk past pos is empty: acc 0, m -inf, l 0; the others hold rows
    live = np.arange(chunks)[None] * chunk_pages * P <= pos[:, None]
    l = part[..., D + 1].numpy()
    np.testing.assert_array_equal(l > 0, np.broadcast_to(live[:, None],
                                                         l.shape))
    empty = torch.from_numpy(~np.broadcast_to(live[:, None], l.shape).copy())
    assert (part[empty][:, :D] == 0).all()
    assert torch.isneginf(part[empty][:, D]).all()
    got = _merged(part)
    assert got.shape == want.shape
    assert np.abs(_f32(got) - want).max() <= _one_ulp(want)


@pytest.mark.parametrize("q8", [False, True])
def test_split_plain_never_reads_dead_rows(q8):
    """NaN in every row no slot owns or past its pos leaves the chunks'
    partials as they were."""
    q, kp, vp, ks, vs, table, pos = _case(8, 2, q8, 9)
    B, P = table.shape[0], 8
    live = np.zeros((kp.shape[0], P), bool)
    for b in range(B):
        for s in range(pos[b] + 1):
            live[table[b, s // P], s % P] = True
    dead = np.broadcast_to(~live[:, None, :], kp.shape[:3])
    args = list(_split_args(q, kp, vp, ks, vs, table, pos))
    want = _split(args, 1)
    if q8:
        for i, a in ((3, ks), (4, vs)):
            args[i] = torch.from_numpy(np.where(dead, np.nan, a).astype(
                np.float32))
    else:
        for i, a in ((1, kp), (2, vp)):
            args[i] = _bf16(np.where(dead[..., None], np.nan, a))
    got = _split(args, 1)
    assert torch.equal(got, want)
    assert torch.isfinite(_merged(got).float()).all()


@pytest.mark.parametrize("B,Hkv,MP", [(8, 32, 26), (8, 8, 26), (8, 8, 104),
                                      (4, 2, 3), (64, 16, 24), (1, 1, 4096),
                                      (4, 32, 26)])
def test_ring_chunks_come_from_shapes_only(B, Hkv, MP):
    """The chunk rule: one chunk from as many (slot, kv head) blocks as
    SMs, else at most MAX_CHUNKS chunks of `pages` pages covering the
    table, about RING_BLOCKS_PER_SM blocks an SM; the same plan serves any
    positions."""
    sms = 132
    pages, chunks = tpa.ring_chunks(B, Hkv, MP, sms)
    assert 1 <= chunks <= min(tpa.MAX_CHUNKS, MP)
    assert (chunks - 1) * pages < MP <= chunks * pages
    if B * Hkv >= sms:
        assert (pages, chunks) == (MP, 1)
    elif B * Hkv * MP <= tpa.RING_BLOCKS_PER_SM * sms:
        # every page could have a block: chunks as small as the cap allows
        assert pages == -(-MP // tpa.MAX_CHUNKS)
    else:
        assert chunks * B * Hkv >= tpa.RING_BLOCKS_PER_SM * sms \
            or chunks == tpa.MAX_CHUNKS


@pytest.mark.parametrize("q8", [False, True])
def test_one_chunk_plan_for_two_pos_vectors(q8):
    """The chunk rule's count, from shapes, gives partials of one shape
    for two pos vectors (one captured graph serves both); each merges to
    the plain decode."""
    q, kp, vp, ks, vs, table, pos = _case(8, 2, q8, 12)
    B, MP, P, Hkv = table.shape[0], table.shape[1], 8, kp.shape[1]
    pages, chunks = tpa.ring_chunks(B, Hkv, MP, 132)
    shapes = set()
    for p in (pos, np.asarray([MP * P - 1, 3, P + 1, 0], np.int32)):
        args = _split_args(q, kp, vp, ks, vs, table, p)
        part = _split(args, pages)
        shapes.add(tuple(part.shape))
        plain = tpa.paged_decode_q8_plain if q8 else tpa.paged_decode_plain
        want = _f32(plain(*args))
        assert np.abs(_f32(_merged(part)) - want).max() <= _one_ulp(want)
    assert shapes == {(B, q.shape[1], chunks, q.shape[3] + 2)}


def test_gathers_match_jax():
    _, kp, _, ks, _, table, _ = _case(8, 1, True, 6)
    np.testing.assert_array_equal(
        tpa.gather_pages(torch.from_numpy(kp), torch.from_numpy(table))
        .numpy(), np.asarray(jpa.gather_pages(jnp.asarray(kp),
                                              jnp.asarray(table))))
    np.testing.assert_array_equal(
        tpa.gather_scale_pages(torch.from_numpy(ks), torch.from_numpy(table))
        .numpy(), np.asarray(jpa.gather_scale_pages(jnp.asarray(ks),
                                                    jnp.asarray(table))))


@pytest.mark.parametrize("q8", [False, True])
def test_paged_append_bit_for_bit(q8):
    """Three appends at ragged positions (a page's last row, the next
    page's first): pools, and int8 bytes and f32 scales, equal JAX's."""
    rng = np.random.default_rng(7)
    B, Hkv, D, P, MP = 3, 2, 16, 8, 3
    N = B * MP + 1
    table = (rng.permutation(N - 1)[:B * MP] + 1).reshape(B, MP).astype(
        np.int32)
    jpools = [jnp.zeros((N, Hkv, P, D), jnp.int8 if q8 else jnp.bfloat16)
              for _ in range(2)]
    tpools = [torch.zeros((N, Hkv, P, D),
                          dtype=torch.int8 if q8 else torch.bfloat16)
              for _ in range(2)]
    jsc = [jnp.zeros((N, Hkv, P), jnp.float32) for _ in range(2)]
    tsc = [torch.zeros((N, Hkv, P)) for _ in range(2)]
    for step in range(3):
        pos = np.asarray([0, 6, 15], np.int32) + step
        k, v = (rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
                for _ in range(2))
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        if q8:
            *jpools, jsc[0], jsc[1] = jpa.paged_append_q8(
                *jpools, *jsc, jk, jv, jnp.asarray(table), jnp.asarray(pos))
            out = tpa.paged_append_q8(*tpools, *tsc, _bf16(k), _bf16(v),
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos))
            assert out[0] is tpools[0] and out[2] is tsc[0]   # in place
        else:
            jpools = list(jpa.paged_append(*jpools, jk, jv,
                                           jnp.asarray(table),
                                           jnp.asarray(pos)))
            out = tpa.paged_append(*tpools, _bf16(k), _bf16(v),
                                   torch.from_numpy(table),
                                   torch.from_numpy(pos))
            assert out[0] is tpools[0]
    for jp, tp in zip(jpools + (jsc if q8 else []),
                      tpools + (tsc if q8 else [])):
        want = np.asarray(jp) if q8 else np.asarray(jp, np.float32)
        got = tp.numpy() if tp.dtype != torch.bfloat16 else tp.float().numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(got, want)


def test_page_allocator_matches_jax():
    ja, ta = jpc.PageAllocator(9, 3, 4), tpc.PageAllocator(9, 3, 4)
    script = [("alloc", 0, 3), ("alloc", 1, 2), ("release", 0), ("alloc", 2, 4),
              ("alloc", 0, 1), ("release", 2), ("release", 1), ("alloc", 1, 4)]
    for op, slot, *n in script:
        got = [getattr(a, op)(slot, *n) for a in (ja, ta)]
        assert got[0] == got[1]
        assert ja.free == ta.free and ja.owned == ta.owned
        assert ja.table_row(slot) == ta.table_row(slot)
        assert ja.can_alloc(4) == ta.can_alloc(4)
    assert ja.pages_needed(17, 8) == ta.pages_needed(17, 8) == 3
    with pytest.raises(MemoryError):
        ta.alloc(0, 99)
    with pytest.raises(MemoryError):
        ta.alloc(1, 1)                  # slot 1 would exceed max_pages


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_paged_kv_cache_and_converter(kv_quant):
    cfg_j = jl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, intermediate=128, max_seq=60)
    cfg_t = tl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, intermediate=128, max_seq=60)
    cj = jl.init_paged_kv_cache(cfg_j, 9, 8, 3, kv_quant=kv_quant)
    ct = tl.init_paged_kv_cache(cfg_t, 9, 8, 3, kv_quant=kv_quant,
                                device="cpu")
    conv = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, cj), "cpu")
    assert set(ct) == set(cj) == set(conv)
    assert ct["block_table"].dtype == conv["block_table"].dtype == torch.int32
    assert tuple(ct["block_table"].shape) == cj["block_table"].shape == (3, 8)
    for key in set(ct) - {"block_table"}:
        assert len(ct[key]) == len(cj[key]) == 2
        assert tuple(ct[key][0].shape) == cj[key][0].shape
        assert ct[key][0].dtype == conv[key][0].dtype
    assert ct["k_pages"][0].dtype == (torch.int8 if kv_quant
                                      else torch.bfloat16)
    c = tpc.init_paged_cache(2, 9, 2, 8, 16, 3, 60, device="cpu")
    assert (c.n_pages, c.max_pages_per_seq, c.page_size) == (9, 8, 8)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_scatter_prefill_into_pages_bit_for_bit(kv_quant):
    rng = np.random.default_rng(11)
    L, Hkv, D, P, S, N = 2, 2, 16, 8, 24, 10
    row = np.asarray([7, 2, 9, 0, 0], np.int32)
    dense = {"k": [], "v": []}
    for key in ("k", "v"):
        for _ in range(L):
            a = rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
            dense[key].append((a * 40).astype(np.int8) if kv_quant else a)
    if kv_quant:
        for key in ("k_scale", "v_scale"):
            dense[key] = [rng.uniform(0.01, 0.02, (1, Hkv, S)).astype(
                np.float32) for _ in range(L)]
    pdt = jnp.int8 if kv_quant else jnp.bfloat16
    jcache = {"k_pages": [jnp.zeros((N, Hkv, P, D), pdt) for _ in range(L)],
              "v_pages": [jnp.zeros((N, Hkv, P, D), pdt) for _ in range(L)],
              "block_table": jnp.zeros((2, 5), jnp.int32)}
    if kv_quant:
        for key in ("ks_pages", "vs_pages"):
            jcache[key] = [jnp.zeros((N, Hkv, P), jnp.float32)
                           for _ in range(L)]
    tcache = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, jcache),
                                        "cpu")
    jdense = {k: [jnp.asarray(a, pdt if a.ndim == 4 else jnp.float32)
                  for a in v] for k, v in dense.items()}
    tdense = {k: [torch.from_numpy(a) if a.dtype != np.float32 or a.ndim == 3
                  else _bf16(a) for a in v] for k, v in dense.items()}
    jout = j_scatter(jcache, jdense, jnp.asarray(row), P)
    tout = t_scatter(tcache, tdense, torch.from_numpy(row), P)
    assert tout is tcache
    for key in jout:
        if key == "block_table":
            continue
        for jp, tp in zip(jout[key], tout[key]):
            want = np.asarray(jp, np.float32)
            assert np.abs(want[row[:3]]).max() > 0
            np.testing.assert_array_equal(tp.float().numpy(), want)


SHAPE = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
             intermediate=1024, max_seq=64)


@pytest.fixture(scope="module")
def model():
    cfg_j = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    params_j = jl.quantize_llama_params(
        jl.init_llama_params(cfg_j, jax.random.PRNGKey(0)), bits=4,
        group_size=128)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    return cfg_j, params_j, tl.LlamaConfig(**SHAPE), params_t


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_decode_step_matches_jax(model, kv_quant):
    """Three decode steps of an INT4 model over a paged cache with a
    shuffled table, crossing a page boundary."""
    cfg_j, params_j, cfg_t, params_t = model
    P, slots, n_pages = 8, 2, 17
    cache_j = jl.init_paged_kv_cache(cfg_j, n_pages, P, slots,
                                     kv_quant=kv_quant)
    table = (np.random.default_rng(3).permutation(n_pages - 1)[:16] + 1
             ).reshape(slots, 8).astype(np.int32)
    cache_j["block_table"] = jnp.asarray(table)
    cache_t = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, cache_j),
                                         "cpu")
    for step, tok in enumerate([[3, 100], [17, 200], [42, 300]]):
        pos = [6 + step, 14 + step]
        with config.override(pallas_interpret=True):
            lj, cache_j = jl.llama_decode_step(
                params_j, cfg_j, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cache_j)
        lt, out = tl.llama_decode_step(
            params_t, cfg_t, torch.tensor(tok, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), cache_t)
        assert out is cache_t
        lj, lt = _f32(lj), _f32(lt)
        assert lt.shape == lj.shape == (2, SHAPE["vocab_size"])
        assert np.isfinite(lt).all()
        assert np.abs(lt - lj).max() <= 3e-2 * np.abs(lj).max()
        np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    # the rows written live where the table says, and nowhere else
    for key in ("k_pages", "v_pages"):
        got, want = _f32(cache_t[key][0]), _f32(cache_j[key][0])
        if kv_quant:
            skey = "ks_pages" if key == "k_pages" else "vs_pages"
            got = got * _f32(cache_t[skey][0])[..., None]
            want = want * _f32(cache_j[skey][0])[..., None]
        np.testing.assert_array_equal(np.abs(got).sum((1, 2, 3)) > 0,
                                      np.abs(want).sum((1, 2, 3)) > 0)
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
