"""Continuous-batching serving engine (greedy decode, one device):
counterpart of infinitensor_tpu/serving/engine.py.

A slot-based continuous batcher: a fixed decode batch of B slots, requests
streaming through the slots. All shapes are static, and the KV cache, the
decode step's `token` and `pos` are static device buffers updated IN PLACE
(the JAX package donates and rebinds them), so on the card ONE decode step
(decode_fn + argmax + token/pos advance) is captured in a CUDA graph per
engine and replayed once per token; a decode chunk is `decode_chunk`
replays and one clone of the tokens they wrote. Prefill runs eagerly.

Flow per step():
  1. admit: pending requests + free slots -> one batched prefill per
     (bucket, lane count) -> the prefill KV written into the slots in place
  2. decode: one step (or chunk) over all B slots (inactive slots compute
     on garbage and are masked out on the host)
  3. retire: sequences hitting eos/max_tokens free their slot

The mesh path of the JAX engine (SPMD serving over dp/tp axes) is not
ported yet: `mesh`, `param_specs` and `cache_specs` are accepted and a
mesh raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import defaultdict, deque
from typing import Callable, Optional

import numpy as np
import torch

from infinitensor_tpu_torch.models.llama import (
    init_kv_cache, llama_decode_step, llama_prefill, llama_verify_step,
)
from infinitensor_tpu_torch.serving.kvcache import merge_prefill_into_slot
from infinitensor_tpu_torch.utils.logging import get_logger
from infinitensor_tpu_torch.utils.platform import resolve_device

_log = get_logger("serving")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _greedy(logits) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _cache_pairs(cache: dict, other: dict):
    """(tensor of cache, its counterpart in other) over a cache dict, whose
    values are per-layer lists or single tensors (a block table)."""
    for key, val in cache.items():
        if isinstance(val, (list, tuple)):
            yield from zip(val, other[key])
        else:
            yield val, other[key]


class _DecodeProgram:
    """The engine's decode step over static buffers: `token` [B], `pos` [B]
    and the engine's cache. One call of `_one` runs decode_fn, takes the
    argmax, writes it into column `_col` of `hist`, makes it the next
    `token` and advances `pos`. On the card `_one` is captured once in a
    CUDA graph (after one eager decode_fn call on a side stream, which
    builds the kernels and rewrites the rows at `pos` with the values the
    first replay writes again) and replayed; on the CPU it runs eagerly."""

    def __init__(self, decode_fn, params, cfg, cache, batch: int, width: int,
                 device: torch.device, use_graph: bool):
        self.decode_fn, self.params, self.cfg = decode_fn, params, cfg
        self.cache = cache
        self.token = torch.zeros(batch, dtype=torch.int32, device=device)
        self.pos = torch.zeros(batch, dtype=torch.int32, device=device)
        self.hist = torch.zeros(batch, width, dtype=torch.int32,
                                device=device)
        self._col = torch.zeros(batch, 1, dtype=torch.int64, device=device)
        self.graph = None
        self.use_graph = use_graph

    def _one(self) -> None:
        logits, _ = self.decode_fn(self.params, self.cfg, self.token,
                                   self.pos, self.cache)
        nxt = _greedy(logits)
        self.hist.scatter_(1, self._col, nxt[:, None])
        self._col.add_(1)
        self.token.copy_(nxt)
        self.pos.add_(1)

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.decode_fn(self.params, self.cfg, self.token, self.pos,
                           self.cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._one()
        self.graph = graph

    def run(self, token, pos, n_steps: int):
        """n_steps greedy steps from (token, pos) [B] int32 on the device.
        Returns (tokens [B, n_steps], last token, next pos), each a tensor
        of its own (not the static buffers)."""
        self.token.copy_(token)
        self.pos.copy_(pos)
        self._col.zero_()
        if self.use_graph and self.graph is None:
            self._capture()
        for _ in range(n_steps):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._one()
        return (self.hist[:, :n_steps].clone(), self.token.clone(),
                self.pos.clone())


class ServingEngine:
    """Model-agnostic continuous batcher. Defaults to the Llama family;
    pass prefill_fn/decode_fn/init_cache_fn for other model families.
    init_cache_fn is called as init_kv_cache is: (cfg, batch, max_seq=,
    dtype=, device=). The engine runs on the card unless `device` says
    "cpu"; parameters must already lie on that device."""

    def __init__(self, params, cfg, max_slots: int = 8,
                 prefill_buckets: tuple = (32, 128, 512),
                 prefill_fn=None, decode_fn=None, init_cache_fn=None,
                 decode_chunk: int = 1, kv_quant: bool = False,
                 mesh=None, param_specs=None, cache_specs=None,
                 spec_decode: int = 0, verify_fn=None, draft=None,
                 checkpoint_interval: int = 0, pipeline_depth: int = 1,
                 lookahead: bool = False, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "serving over a mesh is not ported yet: it waits for the "
                "parallelism modules (ROADMAP.md Queue 1 item 14)")
        self.params = params
        self.cfg = cfg
        self.B = max_slots
        self.device = resolve_device(device)
        if init_cache_fn is None and kv_quant:
            # INT8 KV slots (+ per-row scale planes); the slot-management
            # ops are rank-generic so scales ride along (kvcache.py)
            init_cache_fn = functools.partial(init_kv_cache, kv_quant=True)
        self._init_cache = functools.partial(init_cache_fn or init_kv_cache,
                                             device=self.device)
        self._prefill_fn = prefill_fn or llama_prefill
        self._decode_fn = decode_fn or llama_decode_step
        self.cache = self._init_cache(cfg, max_slots)
        self.mesh = None
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= cfg.max_seq) or (cfg.max_seq,)

        self.pending: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.pos = np.zeros(max_slots, np.int32)        # next write position
        self.last_token = np.zeros(max_slots, np.int32)

        # batched admission: one multi-request prefill per (bucket,
        # lane count): a whole admission wave lands in one pass
        self._prefill_batch: dict[tuple, Callable] = {}
        # fused N-step greedy decode: sequences finishing mid-chunk are
        # truncated on the host, trading a few wasted slot-steps for fewer
        # host round-trips
        self.decode_chunk = max(1, int(decode_chunk))
        self._program: Optional[_DecodeProgram] = None
        # on the card the decode step is captured at its first run; set
        # to False before then to run it eagerly
        self.use_cuda_graph = self.device.type == "cuda"
        self._decode = self._decode_one
        self._decode_multi = self._decode_chunk

        # speculative continuous batching: one K-token verify per engine
        # step (serving/speculative.py semantics, per slot); emitted tokens
        # are defined by the verify logits, accepted prefix lengths vary
        # per slot and per-slot `pos` absorbs the raggedness.
        self.spec_decode = int(spec_decode)
        if self.spec_decode >= 2:
            if verify_fn is None and \
                    self._decode_fn is not llama_decode_step:
                raise ValueError(
                    "spec_decode needs a verify_fn for non-Llama model "
                    "families (the default verify is llama_verify_step)")
            from infinitensor_tpu_torch.serving.speculative import (
                PromptLookupDraft)
            self._verify_fn = verify_fn or llama_verify_step
            self._draft = draft or PromptLookupDraft()
            if not hasattr(self._draft, "propose"):
                raise ValueError(
                    "engine spec_decode needs a per-slot draft with "
                    ".propose(history, k) (e.g. PromptLookupDraft); "
                    "ModelDraft's batch cache cannot follow slot churn - "
                    "use speculative_generate for model drafts")
            self._verify = self._verify_greedy
        self.steps = 0
        self.tokens_out = 0
        # launch-pipelining: dispatch up to `pipeline_depth` decode chunks
        # back-to-back and fetch their tokens ONCE at the end of the group
        # (CUDA launches are asynchronous: the host runs ahead of the
        # card). The group never outruns the shortest request's remaining
        # budget, so the only waste is the within-chunk eos truncation.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # one-group decode lookahead: dispatch group k+1 (token/pos chained
        # DEVICE-side from group k's outputs) BEFORE fetching group k's
        # tokens, so the fetch and the host bookkeeping overlap the next
        # group's device compute. Retirement/admission decisions lag one
        # group (wasted slot-steps bounded by one group; admission flushes
        # first).
        self.lookahead = bool(lookahead)
        self._inflight: Optional[tuple] = None   # (groups, span, active)
        self._dev_state: Optional[tuple] = None  # (token, pos) on device
        # wall-time slices of the serving loop: prefill (launch + fetch),
        # decode dispatch, decode fetch (device compute drains here), host
        # bookkeeping.
        self.stats: dict = defaultdict(float)

        # fault tolerance: when checkpoint_interval > 0, step() snapshots
        # the full serving state to HOST memory every N steps and any
        # failed step restores + retries once (see snapshot/restore).
        self.checkpoint_interval = int(checkpoint_interval)
        self._snap: Optional[dict] = None
        self._last_ckpt_steps = -1
        self._next_uid = 0

    # -- the decode programs -------------------------------------------
    def _run_program(self, token, pos, n_steps: int):
        if self._program is None or self._program.cache is not self.cache:
            self._program = _DecodeProgram(
                self._decode_fn, self.params, self.cfg, self.cache, self.B,
                self.decode_chunk, self.device, self.use_cuda_graph)
        return self._program.run(token, pos, n_steps)

    def _decode_one(self, params, token, pos, cache):
        """(next token [B] int32, cache): one greedy step."""
        toks, _, _ = self._run_program(token, pos, 1)
        return toks[:, 0], cache

    def _decode_chunk(self, params, token, pos, cache):
        """(tokens [B, decode_chunk], last token, next pos, cache)."""
        toks, token, pos = self._run_program(token, pos, self.decode_chunk)
        return toks, token, pos, cache

    def _verify_greedy(self, params, toks, pos, cache):
        logits, cache = self._verify_fn(params, self.cfg, toks, pos, cache)
        return _greedy(logits), cache

    # ------------------------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: Optional[int] = None, uid: Optional[int] = None
               ) -> Request:
        if len(prompt) >= self.cfg.max_seq:
            # reject up front instead of corrupting a slot mid-flight
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq "
                f"{self.cfg.max_seq}; it can never be admitted")
        if uid is None:
            uid = self._next_uid
        # uids must be unique among live requests: snapshot/restore match
        # by uid, so a collision would cross-wire two requests' outputs
        # on the recovery path
        self._next_uid = max(self._next_uid, int(uid) + 1)
        req = Request(uid, list(prompt), max_new_tokens, eos_id)
        self.pending.append(req)
        return req

    def _dev(self, x) -> torch.Tensor:
        """Host value -> tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @staticmethod
    def _host(t) -> np.ndarray:
        """Device int32 tensor -> numpy (the fetch: it waits for the
        launches that produce t)."""
        return t.cpu().numpy().astype(np.int32, copy=False)

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.max_seq

    def _lanes(self, n: int) -> int:
        """Lane counts come from {1, min(4, B), B}: pad lanes waste <=
        (npad / n) x prefill compute, still cheaper than one prefill per
        request."""
        for npad in (1, min(4, self.B), self.B):
            if npad >= n:
                break
        return npad

    def _prefill_batch_fn(self, bucket: int, n: int) -> Callable:
        """One (n-request prefill -> n slot writes -> n first tokens)
        function per (bucket, lane count): an admission WAVE costs one
        prefill pass and one fetch, not one per request. Pad lanes
        duplicate lane 0, an idempotent rewrite of the same slot."""
        key = (bucket, n)
        fn = self._prefill_batch.get(key)
        if fn is not None:
            return fn
        cfg, prefill_fn, init_cache = self.cfg, self._prefill_fn, \
            self._init_cache

        def f(params, toks, cache, slots, plens):
            pcache = init_cache(cfg, n, max_seq=bucket,
                                dtype=cache["k"][0].dtype)
            logits, pcache = prefill_fn(params, cfg, toks, pcache)
            for i in range(n):
                seg = {key2: [buf[i:i + 1] for buf in pcache[key2]]
                       for key2 in pcache}
                cache = merge_prefill_into_slot(cache, seg, int(slots[i]))
            rows = torch.arange(n, device=logits.device)
            first = _greedy(logits[rows, plens.long() - 1])
            return first, cache

        self._prefill_batch[key] = f
        return f

    def _admit(self) -> None:
        while self.pending:
            free = [s for s in range(self.B) if self.slots[s] is None]
            if not free:
                return
            take = []
            while self.pending and len(take) < len(free):
                take.append(self.pending.popleft())
            by_bucket: dict[int, list] = {}
            for req in take:
                by_bucket.setdefault(
                    self._bucket(len(req.prompt)), []).append(req)
            for bucket, reqs in by_bucket.items():
                n = len(reqs)
                npad = self._lanes(n)
                wave_slots = [free.pop(0) for _ in range(n)]
                toks = np.zeros((npad, bucket), np.int32)
                slots_arr = np.zeros((npad,), np.int32)
                plens = np.ones((npad,), np.int32)
                for i, req in enumerate(reqs):
                    S = len(req.prompt)
                    toks[i, :S] = req.prompt
                    slots_arr[i] = wave_slots[i]
                    plens[i] = S
                for i in range(n, npad):    # duplicate lane 0 (idempotent)
                    toks[i] = toks[0]
                    slots_arr[i] = slots_arr[0]
                    plens[i] = plens[0]
                t0 = time.perf_counter()
                first, self.cache = self._prefill_batch_fn(bucket, npad)(
                    self.params, self._dev(toks), self.cache, slots_arr,
                    self._dev(plens))
                first = self._host(first)
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.stats["prefill_launches"] += 1
                self.stats["prefill_tokens"] += float(
                    sum(len(r.prompt) for r in reqs))
                self.stats["prefill_lane_tokens"] += float(npad * bucket)
                for i, req in enumerate(reqs):
                    slot = wave_slots[i]
                    tok = int(first[i])
                    req.generated.append(tok)
                    self.slots[slot] = req
                    self.pos[slot] = len(req.prompt)
                    self.last_token[slot] = tok
                    self.tokens_out += 1
                    _log.info("admit", uid=req.uid, slot=slot,
                              prompt_len=len(req.prompt), bucket=bucket,
                              wave=n)

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self.slots[slot] = None
        _log.info("retire", uid=req.uid, slot=slot,
                  generated=len(req.generated), pos=int(self.pos[slot]))
        self.pos[slot] = 0

    def _n_live(self) -> int:
        return len([r for r in self.slots if r is not None])

    # ------------------------------------------------------------------
    def _spec_step(self, active) -> int:
        """One K-token speculative verify over all live slots."""
        K = self.spec_decode
        inputs = np.zeros((self.B, K), np.int32)
        for slot in active:
            req = self.slots[slot]
            hist = list(req.prompt) + list(req.generated)
            inputs[slot, 0] = self.last_token[slot]
            inputs[slot, 1:] = self._draft.propose(hist, K - 1)
        greedy, self.cache = self._verify(
            self.params, self._dev(inputs), self._dev(self.pos), self.cache)
        greedy = self._host(greedy)
        self.steps += 1
        for slot in active:
            req = self.slots[slot]
            n_acc = 0
            while n_acc < K - 1 and \
                    inputs[slot, n_acc + 1] == greedy[slot, n_acc]:
                n_acc += 1
            for tok in greedy[slot, :n_acc + 1]:
                req.generated.append(int(tok))
                self.tokens_out += 1
                if (req.eos_id is not None and int(tok) == req.eos_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    break
            self.pos[slot] += n_acc + 1
            self.last_token[slot] = int(greedy[slot, n_acc])
            # no force-retire near the cache boundary: step()'s gate
            # routes the next step to dense decode instead, so emitted
            # tokens are identical for any K
            done = (len(req.generated) >= req.max_new_tokens or
                    (req.eos_id is not None
                     and req.eos_id in req.generated)
                    or self.pos[slot] + 1 >= self.cfg.max_seq)
            if done:
                self._retire(slot)
        return self._n_live()

    # -- checkpoint / restore / fault recovery -------------------------
    # ALL serving state is data: host request tables + one KV cache dict.
    # So recovery is: snapshot to host, and on a failed step restore, drop
    # the captured graphs and retry. A step that dies half-way leaves the
    # in-place cache partly written, which only the host copy repairs.

    @staticmethod
    def _pack_req(req: Request) -> dict:
        return {"uid": req.uid, "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens, "eos_id": req.eos_id,
                "generated": list(req.generated), "done": req.done}

    def _extra_snapshot(self) -> dict:
        return {}

    def _extra_restore(self, snap: dict) -> None:
        pass

    def snapshot(self) -> dict:
        """Host-side checkpoint of the complete serving state: request
        tables, slot positions, and the KV cache copied to CPU tensors
        (bf16 has no numpy dtype). The result is process-independent:
        `restore` on a freshly built engine (same config) resumes
        mid-stream generation exactly."""
        self._flush_inflight()     # host state must be current
        def host(t):
            return t.detach().to("cpu", copy=True)

        cache = {key: [host(t) for t in val]
                 if isinstance(val, (list, tuple)) else host(val)
                 for key, val in self.cache.items()}
        return {
            "pending": [self._pack_req(r) for r in self.pending],
            "slots": [None if r is None else self._pack_req(r)
                      for r in self.slots],
            "pos": self.pos.copy(),
            "last_token": self.last_token.copy(),
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "cache": cache,
            "next_uid": self._next_uid,
            **self._extra_snapshot(),
        }

    def restore(self, snap: dict) -> None:
        """Restore a `snapshot()`. Live Request objects are matched by uid
        and updated in place (caller-held handles stay valid across an
        in-process recovery); unmatched entries get fresh objects (the
        cross-process resume path). Live requests submitted AFTER the
        snapshot was taken (uid absent from it) are NOT dropped: they are
        re-queued into pending in submit order - any slot state they had
        is gone with the restored cache, so they restart from prefill.
        The cache is copied INTO the engine's tensors, which keep their
        addresses (a captured decode graph stays valid)."""
        self._inflight = None      # in-flight groups predate the snap
        self._dev_state = None
        live_order = list(self.pending) + \
            [r for r in self.slots if r is not None]
        live = {r.uid: r for r in live_order}

        def unpack(d):
            req = live.get(d["uid"]) or Request(
                d["uid"], list(d["prompt"]), d["max_new_tokens"],
                d["eos_id"])
            req.prompt = list(d["prompt"])
            req.max_new_tokens = d["max_new_tokens"]
            req.eos_id = d["eos_id"]
            req.generated = list(d["generated"])
            req.done = d["done"]
            return req

        self.pending = deque(unpack(d) for d in snap["pending"])
        self.slots = [None if d is None else unpack(d)
                      for d in snap["slots"]]
        snap_uids = {d["uid"] for d in snap["pending"]} | \
            {d["uid"] for d in snap["slots"] if d is not None}
        for req in live_order:
            if req.uid not in snap_uids and not req.done:
                req.generated = []
                self.pending.append(req)
        restored_uids = snap_uids | {r.uid for r in live_order}
        self._next_uid = max(
            [self._next_uid, int(snap.get("next_uid", 0))] +
            [int(u) + 1 for u in restored_uids])
        self.pos = snap["pos"].copy()
        self.last_token = snap["last_token"].copy()
        self.steps = snap["steps"]
        self.tokens_out = snap["tokens_out"]
        for t, src in _cache_pairs(self.cache, snap["cache"]):
            t.copy_(src)
        self._extra_restore(snap)

    def checkpoint(self) -> None:
        self._snap = self.snapshot()
        self._last_ckpt_steps = self.steps

    def _clear_executables(self) -> None:
        """Drop the captured decode graph and the prefill functions so the
        retry builds them again."""
        self._prefill_batch.clear()
        self._program = None

    def step(self) -> int:
        """Admit + one decode step (or one chunk of decode_chunk steps, or
        one speculative verify). Returns number of live sequences. With
        checkpoint_interval > 0 a failed step restores the last
        checkpoint, drops the graphs, and retries once."""
        if self.checkpoint_interval > 0 and (
                self._snap is None or
                self.steps - self._last_ckpt_steps
                >= self.checkpoint_interval):
            self.checkpoint()
        try:
            return self._step_inner()
        except Exception as e:               # noqa: BLE001 - device faults
            if self._snap is None:
                raise
            _log.warning("step_failed_recovering", error=repr(e)[:200],
                         restored_step=self._snap["steps"])
            self._clear_executables()
            self.restore(self._snap)
            return self._step_inner()

    def _flush_inflight(self) -> None:
        """Process any dispatched-but-unfetched lookahead group so host
        state (pos/last_token/slots) is current. Must run before
        admission, snapshot, or any host decision that reads slot
        state. The device-side (token, pos) chain is dropped either way:
        a drain's last group is fetched without a successor, and the chain
        it leaves behind predates whatever admission writes next (the JAX
        package keeps it, so there a second drain's first wave decodes
        from the previous drain's last token and position)."""
        if self._inflight is not None:
            groups, span, active = self._inflight
            self._inflight = None
            self._process_groups(groups, span, active)
        self._dev_state = None

    def _dispatch_chunks(self, token, pos, depth: int):
        t0 = time.perf_counter()
        groups = []
        for _ in range(depth):
            toks, token, pos, self.cache = self._decode_multi(
                self.params, token, pos, self.cache)
            groups.append(toks)
        self.stats["decode_dispatch_s"] += time.perf_counter() - t0
        self.stats["decode_launches"] += depth
        return groups, token, pos

    def _process_groups(self, groups, span: int, active) -> int:
        """Fetch a dispatched group's tokens and run the host
        bookkeeping (emission, eos/max_new retirement). Returns the
        number of retirements."""
        t0 = time.perf_counter()
        toks = np.concatenate([self._host(t) for t in groups], axis=1)
        self.stats["decode_fetch_s"] += time.perf_counter() - t0
        self.steps += span
        self.stats["slot_steps_active"] += span * len(active)
        self.stats["slot_steps_total"] += span * self.B
        retired = 0
        t0 = time.perf_counter()
        for slot in active:
            req = self.slots[slot]
            if req is None:     # retired while this group was in flight
                continue
            for j in range(span):
                tok = int(toks[slot, j])
                req.generated.append(tok)
                self.tokens_out += 1
                self.stats["decode_tokens"] += 1
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    break
            self.pos[slot] += span
            self.last_token[slot] = int(toks[slot, span - 1])
            req_done = (len(req.generated) >= req.max_new_tokens or
                        (req.eos_id is not None and
                         req.eos_id in req.generated) or
                        self.pos[slot] + 1 >= self.cfg.max_seq)
            if req_done:
                self._retire(slot)
                retired += 1
        self.stats["decode_host_s"] += time.perf_counter() - t0
        return retired

    def _lookahead_step(self, active, chunk: int, depth: int) -> int:
        """Dispatch the next decode group BEFORE fetching the previous
        one: the fetch + host loop overlap the new group's device
        compute. token/pos chain device-side between groups."""
        span_new = depth * chunk
        lag = self._inflight[1] if self._inflight is not None else 0
        can_dispatch = int(self.pos[active].max()) + lag + span_new + 1 \
            < self.cfg.max_seq
        if can_dispatch and self._inflight is not None:
            # don't dispatch a group nobody can use: if the in-flight
            # group already covers every active request's remaining
            # budget, the optimistic group would be pure waste (one
            # whole garbage launch at the tail of every wave)
            remaining = max(self.slots[s].max_new_tokens -
                            len(self.slots[s].generated)
                            for s in active)
            if remaining <= lag:
                can_dispatch = False
        new_inflight = None
        if can_dispatch:
            if self._dev_state is not None:
                token, pos = self._dev_state
            else:
                token = self._dev(self.last_token)
                pos = self._dev(self.pos)
            groups, token, pos = self._dispatch_chunks(token, pos, depth)
            self._dev_state = (token, pos)
            new_inflight = (groups, span_new, list(active))
        if self._inflight is not None:
            groups, span, g_active = self._inflight
            self._inflight = None
            retired = self._process_groups(groups, span, g_active)
            if retired or self.pending:
                # host slot state diverged from the device chain: the
                # just-dispatched group must be drained too (its
                # successor would otherwise be re-derived from host
                # state that lags it - a double decode)
                self._inflight = new_inflight
                self._flush_inflight()
                return self._n_live()
        self._inflight = new_inflight
        return self._n_live()

    def _step_inner(self) -> int:
        if self.pending:
            # admission writes prefill state the device chain can't see;
            # catch host state up first
            self._flush_inflight()
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            self._flush_inflight()
            return self._n_live()
        if self.spec_decode >= 2 and \
                int(self.pos[active].max()) + 2 * self.spec_decode < \
                self.cfg.max_seq:
            self._flush_inflight()
            return self._spec_step(active)
        chunk = self.decode_chunk
        lag = self._inflight[1] if self._inflight is not None else 0
        if chunk > 1 and int(self.pos[active].max()) + lag + chunk + 1 < \
                self.cfg.max_seq:
            # pipeline depth: how many chunks can run before the host
            # MUST look at the tokens (shortest remaining budget /
            # max_seq guard); capped at 2 while requests wait so
            # admission isn't starved
            depth = self.pipeline_depth
            if depth > 1:
                horizon = min(self.slots[s].max_new_tokens -
                              len(self.slots[s].generated)
                              for s in active)
                depth = max(1, min(depth, horizon // chunk))
                if self.pending:
                    depth = min(depth, 2)
                while depth > 1 and int(self.pos[active].max()) + \
                        depth * chunk + 1 >= self.cfg.max_seq:
                    depth -= 1
            if self.lookahead:
                return self._lookahead_step(active, chunk, depth)
            groups, _, _ = self._dispatch_chunks(
                self._dev(self.last_token), self._dev(self.pos), depth)
            self._process_groups(groups, chunk * depth, active)
            return self._n_live()
        # single-step (or near-max_seq) path reads host state directly
        self._flush_inflight()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        token = self._dev(self.last_token)
        pos = self._dev(self.pos)
        t0 = time.perf_counter()
        nxt, self.cache = self._decode(self.params, token, pos, self.cache)
        self.stats["decode_dispatch_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        nxt = self._host(nxt)
        self.stats["decode_fetch_s"] += time.perf_counter() - t0
        self.stats["decode_launches"] += 1
        self.steps += 1
        self.stats["slot_steps_active"] += len(active)
        self.stats["slot_steps_total"] += self.B
        for slot in active:
            req = self.slots[slot]
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.tokens_out += 1
            self.stats["decode_tokens"] += 1
            self.pos[slot] += 1
            self.last_token[slot] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = self.pos[slot] + 1 >= self.cfg.max_seq
            if hit_eos or full or len(req.generated) >= req.max_new_tokens:
                self._retire(slot)
        return self._n_live()

    def warmup(self) -> None:
        """Run every program the engine will launch (per-bucket prefill at
        each lane count, decode, chunked decode: on the card this builds
        the kernels and captures the decode graph) by running dummy
        requests per bucket end-to-end, then reset counters. Serving
        deployments warm up before taking traffic; calling this keeps
        set-up time out of throughput measurements."""
        for bucket in self.prefill_buckets:
            # a bucket can equal max_seq (the fallback bucket); the
            # longest admissible prompt still selects that bucket
            plen = min(bucket, self.cfg.max_seq - 1)
            for wave in sorted({1, min(4, self.B), self.B}):
                for _ in range(wave):
                    self.submit([1] * plen,
                                max_new_tokens=max(2, self.decode_chunk))
                self.run_to_completion()
        self.steps = 0
        self.tokens_out = 0
        self.pos[:] = 0
        self.last_token[:] = 0
        self.stats.clear()

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.pending and all(r is None for r in self.slots):
                return
            self.step()
        raise RuntimeError("serving engine did not drain")
