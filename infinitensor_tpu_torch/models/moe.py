"""Mixture-of-Experts FFN (counterpart of infinitensor_tpu/models/moe.py).

Top-k routing with a dense (capacity-free) combine: every expert computes
every token, and the combine weights are zero outside each token's top k.
Exact (no token dropping), the correctness baseline for expert-parallel
variants. The routing keeps every probability at or above the k-th
largest, so a tie at the threshold keeps all tied experts, as the JAX
package's ``probs >= thresh`` does (torch.topk's indices would drop one).

``moe_ffn_ep`` (experts sharded over a mesh axis) comes with the
parallelism modules (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import math

import torch

from infinitensor_tpu_torch.utils.platform import resolve_device


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    n_experts: int, dtype=torch.float32, device=None) -> dict:
    """Random router [dim, E], w_in [E, dim, hidden], w_out [E, hidden,
    dim] (normal / sqrt(fan-in)); `generator` must live on `device`."""
    device = resolve_device(device)

    def normal(*shape, scale):
        w = torch.randn(*shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    scale = 1.0 / math.sqrt(dim)
    return {
        "router": normal(dim, n_experts, scale=scale),
        "w_in": normal(n_experts, dim, hidden, scale=scale),
        "w_out": normal(n_experts, hidden, dim,
                        scale=1.0 / math.sqrt(hidden)),
    }


def _routing_weights(params, x, top_k: int):
    """x [T, d] -> combine weights [T, E] (zero outside top-k, renormed)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    if top_k >= probs.shape[-1]:
        return probs
    thresh = torch.topk(probs, top_k, dim=-1).values[:, -1:]
    kept = torch.where(probs >= thresh, probs, 0.0)
    return kept / kept.sum(-1, keepdim=True).clamp_min(1e-9)


def moe_ffn_ref(params, x, top_k: int = 2):
    """Single-device oracle. x [T, d] -> [T, d] in x's dtype."""
    weights = _routing_weights(params, x, top_k)           # [T, E]
    h = torch.einsum("td,edh->eth", x.float(), params["w_in"].float())
    h = torch.nn.functional.gelu(h, approximate="tanh")
    out = torch.einsum("eth,ehd->etd", h, params["w_out"].float())
    return torch.einsum("etd,te->td", out, weights).to(x.dtype)


def moe_ffn_ep(params, x, mesh=None, axis_name: str = "ep", top_k: int = 2):
    """Expert-parallel MoE: not ported yet."""
    raise NotImplementedError(
        "moe_ffn_ep: expert parallelism comes with the parallelism modules "
        "(ROADMAP.md Queue 1 item 14); moe_ffn_ref is the single-device "
        "form")
