"""The port's serving engines against the JAX package on the same request
streams and the same weights (dense bf16, carried across with
params_from_jax_numpy): generated token lists are equal, the page
allocator ends in the same state, and the recovery paths (snapshot into a
fresh engine, a decode step that raises once) resume to the fault-free
tokens.

Sizes are the JAX tests' own: vocab 128, dim 64, 2 layers, 4 heads, 2 kv
heads, pages of 8 rows. At dim 64 neither side takes a kernel for a
matmul; attention is the JAX package's reference path on one side and the
plain versions on the other, both f32 with one bf16 rounding. Alone at
batch 1 the two give bit-equal logits; in a batch XLA's CPU matmul sums in
another order, and since logits are bf16 (1/64 apart near 3) the top two
of a random model are often one ulp apart, where that flips the argmax.
So token lists are held equal, except that a request may part ways at a
near-tie (_same_tokens: the port's logits of the two candidates after the
common prefix lie within one bf16 ulp); what follows a near-tie has another
history and is not compared. Everything that does not depend on token
values (steps, stats counters, allocator state, block table) is equal.
"""

import math
import types


import numpy as np
import jax
import pytest
import torch

from infinitensor_tpu.models import llama as jl
from infinitensor_tpu.serving import engine as jeng
from infinitensor_tpu.serving import kvcache as jkv
from infinitensor_tpu.serving import paged_engine as jpaged
from infinitensor_tpu.serving import speculative as jspec

import chip_smoke
from infinitensor_tpu_torch.models import llama as tl
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.serving import (
    ModelDraft, PagedServingEngine, PromptLookupDraft, Request,
    ServingEngine, clear_kv_slot, clone_kv_slot, speculative_generate,
    write_prefill_into_slot)

SHAPE = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             intermediate=128)
PAGE = 8
PROMPTS = [[3, 5, 7], [11, 13], [17, 19, 23, 29]]


@pytest.fixture(scope="module")
def model():
    cfg_j = jl.LlamaConfig(max_seq=128, **SHAPE)
    params_j = jl.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    return cfg_j, params_j, tl.LlamaConfig(max_seq=128, **SHAPE), params_t


def _requests(seed, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, SHAPE["vocab_size"], int(p)).tolist(), int(m))
            for p, m in zip(rng.integers(4, 24, n), rng.integers(6, 16, n))]


def _run(eng, reqs):
    rs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    eng.run_to_completion()
    assert all(r.done for r in rs)
    return [list(r.generated)[:m] for r, (_, m) in zip(rs, reqs)]


def _same_tokens(model, reqs, got, want, min_equal=None):
    """got == want per request, or the first difference is a near-tie."""
    _, _, cfg_t, params_t = model
    equal = 0
    for (prompt, _), g, w in zip(reqs, got, want):
        assert len(g) == len(w)
        if g == w:
            equal += 1
            continue
        j = next(j for j, (x, y) in enumerate(zip(g, w)) if x != y)
        logits, _ = tl.llama_prefill(
            params_t, cfg_t,
            torch.tensor([list(prompt) + g[:j]], dtype=torch.int32),
            tl.init_kv_cache(cfg_t, 1, device="cpu"))
        last = logits[0, -1].float()
        ulp = 2.0 ** (math.floor(math.log2(float(last.abs().max()))) - 7)
        assert abs(float(last[g[j]] - last[w[j]])) <= ulp, (prompt, j, g, w)
    # near-ties are the exception
    assert equal >= (len(reqs) - 2 if min_equal is None else min_equal)


def _jax_reference(model, **kw):
    """The JAX package's DENSE engine on a paged engine's arguments: the
    fault-free reference of the port's paged engine. The JAX paged engine
    lets a retired slot's stale block-table row write into a live page
    (ROADMAP.md Queue 3 item 4), which the port repairs."""
    cfg_j, params_j, _, _ = model
    kw = {k: v for k, v in kw.items() if k not in ("n_pages", "page_size")}
    return jeng.ServingEngine(params_j, cfg_j, **kw)


def _pair(model, paged, **kw):
    """The JAX engine and the port's with the same arguments."""
    cfg_j, params_j, cfg_t, params_t = model
    if paged:
        kw = dict(dict(n_pages=33, page_size=PAGE), **kw)
        return (jpaged.PagedServingEngine(params_j, cfg_j, **kw),
                PagedServingEngine(params_t, cfg_t, device="cpu", **kw))
    return (jeng.ServingEngine(params_j, cfg_j, **kw),
            ServingEngine(params_t, cfg_t, device="cpu", **kw))


DENSE_CASES = {
    "bf16": dict(),
    "kv_quant": dict(kv_quant=True),
    "chunk4": dict(decode_chunk=4),
    "chunk4_depth2": dict(decode_chunk=4, pipeline_depth=2),
    "lookahead": dict(decode_chunk=4, pipeline_depth=2, lookahead=True),
    "spec4": dict(spec_decode=4),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_serving_engine_tokens_match_jax(model, case):
    reqs = _requests(1)
    je, te = _pair(model, False, max_slots=4, prefill_buckets=(8, 24),
                   **DENSE_CASES[case])
    want, got = _run(je, reqs), _run(te, reqs)
    _same_tokens(model, reqs, got, want)
    assert te.steps == je.steps and te.tokens_out == je.tokens_out
    for key in ("prefill_launches", "prefill_lane_tokens", "decode_launches",
                "slot_steps_active", "slot_steps_total", "decode_tokens"):
        assert te.stats.get(key, 0) == je.stats.get(key, 0), key


PAGED_CASES = {
    "bf16": dict(),
    "kv_quant": dict(kv_quant=True),
    "chunk4": dict(decode_chunk=4),
    "lookahead": dict(decode_chunk=4, pipeline_depth=2, lookahead=True),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_engine_tokens_match_jax(model, case):
    """The port's paged engine: tokens of the JAX dense engine (the JAX
    paged engine's stale rows hit live pages on this stream), and the JAX
    paged engine's page allocation; every retired row at the trash page."""
    reqs = _requests(2)
    kw = dict(max_slots=4, prefill_buckets=(24,), **PAGED_CASES[case])
    je, te = _pair(model, True, **kw)
    want = _run(_jax_reference(model, **kw), reqs)
    _run(je, reqs)
    got = _run(te, reqs)
    _same_tokens(model, reqs, got, want)
    assert te.allocator.free == je.allocator.free
    assert te.allocator.owned == je.allocator.owned
    assert te.free_pages == 32
    assert not te.cache["block_table"].any()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_matches_dense_engine(model, kv_quant):
    _, _, cfg_t, params_t = model
    reqs = _requests(3, n=10)
    kw = dict(max_slots=4, prefill_buckets=(24,), kv_quant=kv_quant,
              device="cpu")
    dense = _run(ServingEngine(params_t, cfg_t, **kw), reqs)
    paged = _run(PagedServingEngine(params_t, cfg_t, n_pages=33,
                                    page_size=PAGE, **kw), reqs)
    assert paged == dense


def test_engine_tokens_equal_greedy_generate(model):
    _, _, cfg_t, params_t = model
    reqs = _requests(4, n=5)
    got = _run(ServingEngine(params_t, cfg_t, max_slots=2,
                             prefill_buckets=(8, 24), device="cpu"), reqs)
    for (prompt, m), toks in zip(reqs, got):
        want, _ = tl.greedy_generate(
            params_t, cfg_t, torch.tensor([prompt], dtype=torch.int32), m)
        assert toks == want[0].tolist()


def test_pool_smaller_than_slots_drains_and_reclaims(model):
    """Total traffic exceeds the pool's one-time capacity, and the pool is
    far smaller than max_slots * max_seq: completion proves admission
    control and reclaim; the allocator ends as the JAX engine's does."""
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 128, 12).tolist(), 10) for _ in range(12)]
    je, te = _pair(model, True, max_slots=4, n_pages=17,
                   prefill_buckets=(16,))
    assert 16 * PAGE < 4 * 128 and 16 * PAGE < 12 * 22
    want, got = _run(je, reqs), _run(te, reqs)
    _same_tokens(model, reqs, got, want)
    assert all(len(g) == 10 for g in got)
    assert te.free_pages == 16
    assert all(not owned for owned in te.allocator.owned)
    assert te.allocator.free == je.allocator.free


def test_admission_blocks_until_reclaim(model):
    """FIFO admission control: with the pool nearly full, a new request
    waits in pending instead of corrupting live pages."""
    rng = np.random.default_rng(6)
    je, te = _pair(model, True, max_slots=4, n_pages=9,
                   prefill_buckets=(16,))
    # each request needs ceil((14+20+1+1)/8)=5 pages; the pool has 8 usable
    reqs = [rng.integers(1, 128, 14).tolist() for _ in range(2)]
    out = []
    for eng in (je, te):
        a, b = (eng.submit(p, max_new_tokens=20) for p in reqs)
        eng.step()
        assert not a.done and len(eng.pending) == 1  # b blocked, a admitted
        eng.run_to_completion()
        assert a.done and b.done and eng.free_pages == 8
        out.append([list(a.generated), list(b.generated)])
    assert out[0] == out[1]


def test_paged_submit_rejects_never_admittable(model):
    _, _, cfg_t, params_t = model
    eng = PagedServingEngine(params_t, cfg_t, max_slots=2, n_pages=5,
                             page_size=PAGE, prefill_buckets=(16,),
                             device="cpu")
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(1, 30)), max_new_tokens=20)
    assert not eng.pending
    # buckets are page-aligned, the max_seq fallback included
    odd = PagedServingEngine(params_t, cfg_t, max_slots=2, n_pages=33,
                             page_size=PAGE, prefill_buckets=(12, 20),
                             device="cpu")
    assert odd.prefill_buckets == (16, 24) and odd._bucket(30) == 128


def _jax_stale_rows(eng):
    """chip_smoke.stale_row_hazards of the JAX engine (its table is a jax
    array)."""
    table = torch.from_numpy(np.array(eng.cache["block_table"]))
    return chip_smoke.stale_row_hazards(types.SimpleNamespace(
        cache={"block_table": table}, B=eng.B, slots=eng.slots,
        allocator=eng.allocator))


def test_stale_block_table_row_matches_jax(model):
    """A retired slot of the JAX engine keeps its block-table row on the
    device, and its garbage decode (pos 0) writes row 0 of the row's first
    page, which the allocator may since have handed to a live request. The
    port repairs that (its _retire points the row at the trash page 0). On
    a stream where it happens in the JAX engine (request 9), no idle row of
    the port's table points at a live page, the port's paged tokens equal
    the dense engine's, and the other requests' tokens, the allocator and
    the live rows of the table equal the JAX engine's."""
    _, _, cfg_t, params_t = model
    reqs = _requests(20, n=10)
    kw = dict(max_slots=4, n_pages=17, prefill_buckets=(24,))
    je, te = _pair(model, True, **kw)
    hazards, out = [set(), set()], []
    for k, eng in enumerate((je, te)):
        rs = [eng.submit(p, max_new_tokens=m, uid=i)
              for i, (p, m) in enumerate(reqs)]
        while eng.pending or any(r is not None for r in eng.slots):
            eng.step()
            hazards[k] |= (_jax_stale_rows(eng) if eng is je
                           else chip_smoke.stale_row_hazards(eng))
        out.append([list(r.generated) for r in rs])
    assert hazards[0] == {(9, 0)}   # JAX: request 9, row 0 of its 1st page
    assert not hazards[1]
    dense = _run(ServingEngine(params_t, cfg_t, max_slots=4,
                               prefill_buckets=(24,), device="cpu"), reqs)
    assert out[1] == dense
    _same_tokens(model, reqs[:9], out[1][:9], out[0][:9])
    assert te.allocator.free == je.allocator.free
    assert not te.cache["block_table"].any()    # every slot retired
    assert np.asarray(je.cache["block_table"]).any()


def test_chip_smoke_stream_blocks_admission_without_stale_rows():
    """The request stream chip_smoke.py serves at full width, here at a
    tiny width (with eos unset the schedule follows from the lengths
    alone): admission waits for pages, and no idle slot's stale row points
    at a live page, so there the paged and the dense engine must agree."""
    cfg = tl.LlamaConfig(max_seq=chip_smoke.MAX_SEQ, **dict(SHAPE, n_layers=1))
    params = tl.init_llama_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    eng = PagedServingEngine(
        params, cfg, max_slots=chip_smoke.SLOTS,
        n_pages=chip_smoke.POOL_PAGES, page_size=chip_smoke.PAGE,
        prefill_buckets=chip_smoke.BUCKETS, decode_chunk=chip_smoke.CHUNK,
        device="cpu")
    reqs = chip_smoke.serving_requests(np, cfg)
    assert len(reqs) == chip_smoke.REQUESTS
    assert (chip_smoke.POOL_PAGES - 1) * chip_smoke.PAGE \
        < chip_smoke.SLOTS * cfg.max_seq
    rs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    waited, hazards, admit = [0], set(), eng._admit

    def counted_admit():
        admit()
        waited[0] += bool(eng.pending) and None in eng.slots

    eng._admit = counted_admit
    while eng.pending or any(r is not None for r in eng.slots):
        eng.step()
        hazards |= chip_smoke.stale_row_hazards(eng)
    assert all(r.done and len(r.generated) == m
               for r, (_, m) in zip(rs, reqs))
    assert waited[0] > 0 and not hazards
    assert eng.free_pages == chip_smoke.POOL_PAGES - 1


# -- checkpoint / restore / fault recovery ---------------------------------

CFG64 = dict(SHAPE, max_seq=64)


@pytest.fixture(scope="module")
def model64():
    cfg_j = jl.LlamaConfig(**CFG64)
    params_j = jl.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    return cfg_j, params_j, tl.LlamaConfig(**CFG64), params_t


def _drain(engine, prompts=PROMPTS, max_new=6):
    reqs = [engine.submit(p, max_new_tokens=max_new, uid=100 + i)
            for i, p in enumerate(prompts)]
    engine.run_to_completion()
    return [list(r.generated) for r in reqs]


class FlakyDecode:
    """Raises on the n-th call, then delegates."""

    def __init__(self, inner, fail_on):
        self.inner, self.calls, self.fail_on = inner, 0, fail_on
        self.faults = 0

    def __call__(self, *args):
        self.calls += 1
        if self.calls == self.fail_on:
            self.faults += 1
            raise RuntimeError("injected device fault")
        return self.inner(*args)


RECOVERY_CASES = {
    "dense_every_step": (False, dict(checkpoint_interval=1), 3),
    "dense_coarse": (False, dict(checkpoint_interval=4), 6),
    "paged_every_step": (True, dict(checkpoint_interval=1, n_pages=16,
                                    prefill_buckets=(8, 16)), 2),
}


@pytest.mark.parametrize("case", list(RECOVERY_CASES))
def test_fault_recovery_matches_fault_free(model64, case):
    """A decode step that raises once: the engine restores its last
    checkpoint, drops its programs and regenerates the fault-free tokens,
    which are the JAX engine's (its dense engine for a paged case: see
    _jax_reference)."""
    paged, kw, fail_on = RECOVERY_CASES[case]
    plain = {k: v for k, v in kw.items() if k != "checkpoint_interval"}
    je, te = _pair(model64, paged, max_slots=2, **plain)
    if paged:
        je = _jax_reference(model64, max_slots=2, **plain)
    want = _drain(je)
    assert _drain(te) == want
    _, eng = _pair(model64, paged, max_slots=2, **kw)
    free_at_start = eng.free_pages if paged else None
    eng._decode = flaky = FlakyDecode(eng._decode, fail_on=fail_on)
    got = _drain(eng)
    assert flaky.faults == 1          # the fault actually fired
    assert got == want                # recovery replayed exactly
    if paged:
        assert eng.free_pages == free_at_start


RESUME_CASES = {
    "dense": (False, dict(), 4),
    "dense_kv_quant": (False, dict(kv_quant=True), 3),
    "paged": (True, dict(n_pages=16, prefill_buckets=(8, 16)), 3),
    "paged_kv_quant": (True, dict(n_pages=16, prefill_buckets=(8, 16),
                                  kv_quant=True), 3),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_checkpoint_resume_fresh_engine(model64, case):
    """snapshot() mid-flight restores onto a freshly built engine and
    completes with the uninterrupted run's tokens, which are the JAX
    engine's (its dense engine for a paged case: see _jax_reference); the
    snapshot is host data (CPU tensors, numpy, lists)."""
    paged, kw, steps = RESUME_CASES[case]
    je, te = _pair(model64, paged, max_slots=2, **kw)
    if paged:
        je = _jax_reference(model64, max_slots=2, **kw)
    want = _drain(je)
    assert _drain(te) == want
    _, a = _pair(model64, paged, max_slots=2, **kw)
    for i, p in enumerate(PROMPTS):
        a.submit(p, max_new_tokens=6, uid=100 + i)
    for _ in range(steps):
        a.step()
    snap = a.snapshot()
    key = "k_pages" if paged else "k"
    assert snap["cache"][key][0].device.type == "cpu"
    assert snap["cache"][key][0].dtype == a.cache[key][0].dtype
    assert snap["cache"][key][0] is not a.cache[key][0]
    _, b = _pair(model64, paged, max_slots=2, **kw)
    tensors = [t.data_ptr() for t in b.cache[key]]
    b.restore(snap)
    assert [t.data_ptr() for t in b.cache[key]] == tensors   # in place
    handles = {r.uid: r for r in list(b.pending)
               + [r for r in b.slots if r is not None]}
    b.run_to_completion()
    got = [list(handles[100 + i].generated) for i in range(len(PROMPTS))]
    assert got == want
    assert b.steps >= snap["steps"]
    if paged:
        assert b.free_pages == 15


def test_post_checkpoint_submit_survives_recovery(model64):
    """A request submitted AFTER the last checkpoint is re-queued from
    prefill when a fault rolls the engine back."""
    _, _, cfg_t, params_t = model64
    ref = ServingEngine(params_t, cfg_t, max_slots=2, device="cpu")
    r_ref = ref.submit([41, 43, 47], max_new_tokens=6, uid=500)
    ref.run_to_completion()
    eng = ServingEngine(params_t, cfg_t, max_slots=2,
                        checkpoint_interval=100, device="cpu")
    eng.submit([3, 5, 7], max_new_tokens=4, uid=100)
    eng.step()                       # takes the one-and-only checkpoint
    late = eng.submit([41, 43, 47], max_new_tokens=6, uid=500)
    eng._decode = flaky = FlakyDecode(eng._decode, fail_on=2)
    eng.run_to_completion()
    assert flaky.faults == 1
    assert late.done and list(late.generated) == list(r_ref.generated)


def test_restore_advances_next_uid(model64):
    _, _, cfg_t, params_t = model64
    a = ServingEngine(params_t, cfg_t, max_slots=2, device="cpu")
    a.submit([3, 5, 7], max_new_tokens=6)           # default uid 0
    a.submit([11, 13], max_new_tokens=6)            # default uid 1
    a.step()
    snap = a.snapshot()
    b = ServingEngine(params_t, cfg_t, max_slots=2, device="cpu")
    b.restore(snap)
    fresh = b.submit([17, 19], max_new_tokens=4)
    live_uids = [r.uid for r in list(b.pending)
                 + [r for r in b.slots if r is not None]]
    assert len(live_uids) == len(set(live_uids)) and fresh.uid >= 2
    b.run_to_completion()
    assert fresh.done and len(fresh.generated) > 0


def test_engine_arguments(model64):
    _, _, cfg_t, params_t = model64
    eng = ServingEngine(params_t, cfg_t, max_slots=2, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(list(range(cfg_t.max_seq)))
    for cls in (ServingEngine, PagedServingEngine):
        with pytest.raises(NotImplementedError, match="item 14"):
            cls(params_t, cfg_t, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="propose"):
        ServingEngine(params_t, cfg_t, spec_decode=4, draft=object(),
                      device="cpu")
    with pytest.raises(ValueError, match="verify_fn"):
        ServingEngine(params_t, cfg_t, spec_decode=4, device="cpu",
                      decode_fn=lambda *a: tl.llama_decode_step(*a))
    assert isinstance(eng.submit([1, 2]), Request)


def test_injected_model_functions_and_warmup(model64):
    """prefill_fn / decode_fn / init_cache_fn injection, and warmup, which
    leaves the counters at zero and the engine ready."""
    _, _, cfg_t, params_t = model64
    calls = {"prefill": 0, "decode": 0, "init": 0}

    def prefill(*a):
        calls["prefill"] += 1
        return tl.llama_prefill(*a)

    def decode(*a):
        calls["decode"] += 1
        return tl.llama_decode_step(*a)

    def init(cfg, batch, max_seq=None, dtype=None, device=None):
        calls["init"] += 1
        return tl.init_kv_cache(cfg, batch, max_seq, dtype, device=device)

    eng = ServingEngine(params_t, cfg_t, max_slots=2, prefill_buckets=(8,),
                        prefill_fn=prefill, decode_fn=decode,
                        init_cache_fn=init, decode_chunk=2, device="cpu")
    eng.warmup()
    assert all(calls.values())
    assert eng.steps == eng.tokens_out == 0 and not eng.stats
    assert _drain(eng) == _drain(ServingEngine(
        params_t, cfg_t, max_slots=2, prefill_buckets=(8,), device="cpu"))


# -- speculative decoding and slot management ------------------------------

def test_speculative_generate_equals_greedy_and_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    prompt = np.asarray([[5, 9, 5, 9, 5, 9, 5], [7, 3, 7, 3, 7, 3, 7]],
                        np.int32)
    want, _ = tl.greedy_generate(params_t, cfg_t, torch.from_numpy(prompt),
                                 12)
    got, stats = speculative_generate(params_t, cfg_t,
                                      torch.from_numpy(prompt), 12, K=4)
    np.testing.assert_array_equal(got, want.numpy())
    jgot, jstats = jspec.speculative_generate(params_j, cfg_j, prompt, 12,
                                              K=4)
    np.testing.assert_array_equal(got, np.asarray(jgot))
    assert stats == jstats
    # a model draft (the target itself: every proposal is accepted)
    draft = ModelDraft(params_t, cfg_t, batch=2,
                       max_seq=cfg_t.max_seq + 16)
    got2, stats2 = speculative_generate(params_t, cfg_t, prompt, 12, K=4,
                                        draft=draft)
    np.testing.assert_array_equal(got2, want.numpy())
    assert stats2["accept_rate"] == 1.0


def test_prompt_lookup_draft_matches_jax():
    rng = np.random.default_rng(0)
    for ngram in (1, 2, 3):
        jd, td = jspec.PromptLookupDraft(ngram), PromptLookupDraft(ngram)
        for _ in range(20):
            hist = rng.integers(0, 4, int(rng.integers(1, 12))).tolist()
            assert td.propose(hist, 3) == jd.propose(hist, 3)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_slot_functions_match_jax(kv_quant):
    """clone / clear / write-prefill on the slot cache, scale planes
    included: equal to JAX's results, and in place."""
    cfg_j = jl.LlamaConfig(max_seq=16, **SHAPE)
    cfg_t = tl.LlamaConfig(max_seq=16, **SHAPE)
    rng = np.random.default_rng(12)

    def fill(shape, dtype):
        if dtype == np.int8:
            return rng.integers(-127, 128, shape).astype(np.int8)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    cache_j = jl.init_kv_cache(cfg_j, 3, kv_quant=kv_quant)
    pre_j = jl.init_kv_cache(cfg_j, 1, max_seq=8, kv_quant=kv_quant)
    cache_j, pre_j = (
        {k: [jax.numpy.asarray(fill(b.shape, np.int8 if b.dtype == np.int8
                                    else np.float32), b.dtype) for b in v]
         for k, v in c.items()} for c in (cache_j, pre_j))
    cache_t, pre_t = (params_from_jax_numpy(jax.tree.map(np.asarray, c),
                                            "cpu") for c in (cache_j, pre_j))
    ptrs = [t.data_ptr() for t in cache_t["k"]]
    cache_j = jkv.write_prefill_into_slot(cache_j, pre_j, 1)
    cache_j = jkv.clone_kv_slot(cache_j, 1, 2)
    cache_j = jkv.clear_kv_slot(cache_j, 0)
    assert write_prefill_into_slot(cache_t, pre_t, 1) is cache_t
    clone_kv_slot(cache_t, 1, 2)
    clear_kv_slot(cache_t, 0)
    assert [t.data_ptr() for t in cache_t["k"]] == ptrs
    assert set(cache_t) == set(cache_j)
    for key in cache_j:
        for tj, tt in zip(cache_j[key], cache_t[key]):
            np.testing.assert_array_equal(tt.float().numpy(),
                                          np.asarray(tj, np.float32))


PAIRED_SHAPE = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                    n_kv_heads=2, intermediate=1024, max_seq=64)


def test_paired_engine_tokens_match_jax():
    """A paired-weight model (quantize_llama_params(paired=True), by the
    JAX package, bytes handed to the port) through the dense
    ServingEngine with an INT8 cache: 4 requests over 2 slots, so its
    decode steps run 2 rows (on the card qmm_slab_norm_mma for wqkv and
    w_gateup, qmm_slab_mma for wo, w_down and the lm_head; on the CPU
    qmm_slab_plain) against the JAX engine on the same stream (on the CPU
    it dequantizes each paired weight to bf16, so logits differ by a few
    bf16 ulps): tokens equal, or a request parts at a near-tie, where each
    side's pick is within the two sides' measured logit error of the
    other's (as test_torch_llama.py's _close_logits holds it); steps and
    stats equal."""
    cfg_j = jl.LlamaConfig(**PAIRED_SHAPE)
    params_j = jl.quantize_llama_params(
        jl.init_llama_params(cfg_j, jax.random.PRNGKey(4)), bits=4,
        group_size=128, paired=True)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    assert params_t["layers"][0]["wqkv"].paired
    model = (cfg_j, params_j, tl.LlamaConfig(**PAIRED_SHAPE), params_t)
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(1, 512, int(p)).tolist(), int(m))
            for p, m in zip(rng.integers(4, 20, 4), rng.integers(4, 8, 4))]
    je, te = _pair(model, False, max_slots=2, prefill_buckets=(8, 24),
                   kv_quant=True)
    want, got = _run(je, reqs), _run(te, reqs)
    equal = 0
    for (prompt, _), g, w in zip(reqs, got, want):
        if g == w:
            equal += 1
            continue
        j = next(j for j, (x, y) in enumerate(zip(g, w)) if x != y)
        toks = [list(prompt) + g[:j]]
        lt, _ = tl.llama_prefill(
            params_t, model[2], torch.tensor(toks, dtype=torch.int32),
            tl.init_kv_cache(model[2], 1, device="cpu"))
        lj, _ = jl.llama_prefill(params_j, cfg_j,
                                 jax.numpy.asarray(toks, np.int32),
                                 jl.init_kv_cache(cfg_j, 1))
        lt = lt[0, -1].float().numpy()
        lj = np.asarray(lj[0, -1], np.float32)
        err = np.abs(lt - lj).max()
        assert lt[g[j]] - lt[w[j]] <= err and lj[w[j]] - lj[g[j]] <= err, \
            (prompt, j, g, w, err)
    assert equal >= len(reqs) - 2
    assert te.steps == je.steps and te.tokens_out == je.tokens_out
    for key in ("prefill_launches", "decode_launches", "slot_steps_active",
                "decode_tokens"):
        assert te.stats.get(key, 0) == je.stats.get(key, 0), key
