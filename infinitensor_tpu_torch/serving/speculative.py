"""Speculative decoding (counterpart of
infinitensor_tpu/serving/speculative.py): draft K tokens cheaply, verify
them in ONE target-model forward (models/llama.py llama_verify_step),
accept the longest greedy-matching prefix. Lossless: emitted tokens are
exactly the target model's greedy decode. The per-position causal masks
mean rejection needs NO cache rollback (not advancing ``pos`` is the
rollback).

Draft strategies:
* ModelDraft    - a smaller/quantized model sharing the tokenizer;
* PromptLookupDraft - n-gram continuation lookup over the slot's own
                  history (host-side, no second model).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from infinitensor_tpu_torch.models.llama import (
    init_kv_cache, llama_decode_multi, llama_prefill, llama_verify_step,
)


class PromptLookupDraft:
    """Propose continuations by matching the trailing n-gram against the
    slot's own (prompt + generated) history."""

    def __init__(self, ngram: int = 2):
        self.ngram = max(1, int(ngram))

    def propose(self, history: Sequence[int], k: int) -> list:
        hist = list(history)
        for n in range(min(self.ngram, len(hist) - 1), 0, -1):
            tail = hist[-n:]
            # most recent earlier occurrence of the tail
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == tail:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return (cont + [hist[-1]] * k)[:k]
        return [hist[-1]] * k   # degenerate fallback: repeat


def _tokens(x, device) -> torch.Tensor:
    """Host array or tensor -> int32 tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.int32).to(device)


class ModelDraft:
    """Greedy draft from a (smaller / lower-precision) model sharing the
    target's tokenizer. Maintains its own KV cache on the device of its
    embedding; mispredictions need no rollback (pos gating)."""

    def __init__(self, params, cfg, batch: int,
                 max_seq: Optional[int] = None):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.cache = init_kv_cache(cfg, batch, max_seq=max_seq,
                                   device=self.device)

    def start(self, prompt_tokens) -> None:
        llama_prefill(self.params, self.cfg,
                      _tokens(prompt_tokens, self.device), self.cache)

    def propose_batch(self, token, pos, k: int) -> np.ndarray:
        """token/pos [B] -> proposals [B, k] (greedy; all k draft steps in
        one llama_decode_multi call)."""
        toks, *_ = llama_decode_multi(
            self.params, self.cfg, _tokens(token, self.device),
            _tokens(pos, self.device), self.cache, k)
        return toks.cpu().numpy().astype(np.int32, copy=False)


def speculative_generate(params, cfg, prompt_tokens, n_steps: int,
                         K: int = 4, draft=None,
                         cache=None) -> tuple:
    """Greedy speculative decode. prompt_tokens [B, S] (a tensor, whose
    device is used, or an array, which goes to the device of the
    embedding); returns (tokens [B, n_steps] int32 numpy, stats dict).
    Output tokens are identical to greedy_generate's (lossless
    acceptance).

    draft: ModelDraft | PromptLookupDraft | None (defaults to
    prompt-lookup). K counts the verify width: 1 committed token + K-1
    draft proposals per verify pass."""
    device = prompt_tokens.device if isinstance(prompt_tokens, torch.Tensor) \
        else params["embed"].device
    prompt_tokens = _tokens(prompt_tokens, device)
    B, S = prompt_tokens.shape
    K = max(2, int(K))
    if draft is None:
        draft = PromptLookupDraft()
    if cache is None:
        # verify writes up to K rows past the last committed position
        cache = init_kv_cache(cfg, B, max_seq=max(cfg.max_seq,
                                                  S + n_steps + 2 * K),
                              device=device)

    logits, cache = llama_prefill(params, cfg, prompt_tokens, cache)
    cur = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
    pos = np.full((B,), S, np.int32)

    prompt_host = prompt_tokens.cpu().numpy()
    history = [list(prompt_host[b]) + [int(cur[b])] for b in range(B)]
    out: list = [[int(cur[b])] for b in range(B)]
    if isinstance(draft, ModelDraft):
        draft.start(prompt_tokens)

    launches = accepted_total = proposed_total = 0
    while any(len(o) < n_steps for o in out):
        if isinstance(draft, ModelDraft):
            props = draft.propose_batch(cur, pos, K - 1)       # [B, K-1]
        else:
            props = np.stack([
                np.asarray(draft.propose(history[b], K - 1), np.int32)
                for b in range(B)])
        inputs = np.concatenate([cur[:, None], props[:, :K - 1]], axis=1)
        logits, cache = llama_verify_step(
            params, cfg, _tokens(inputs, device), _tokens(pos, device),
            cache)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy().astype(
            np.int32)                                           # [B, K]
        launches += 1
        for b in range(B):
            if len(out[b]) >= n_steps:
                pos[b] += 1     # keep feeding; emitted tokens are final
                cur[b] = greedy[b, 0]
                continue
            n_acc = 0
            while n_acc < K - 1 and props[b, n_acc] == greedy[b, n_acc]:
                n_acc += 1
            emit = list(greedy[b, :n_acc + 1])
            accepted_total += n_acc
            proposed_total += K - 1
            out[b].extend(int(t) for t in emit)
            history[b].extend(int(t) for t in emit)
            pos[b] += n_acc + 1
            cur[b] = greedy[b, n_acc]
    tokens = np.asarray([o[:n_steps] for o in out], np.int32)
    stats = {
        "verify_launches": launches,
        "accept_rate": (accepted_total / proposed_total
                        if proposed_total else 0.0),
        "tokens_per_launch": tokens.size / max(launches, 1),
    }
    return tokens, stats
