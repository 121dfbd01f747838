"""Checkpoint loaders: HuggingFace state dicts -> the port's parameter
dicts (counterpart of infinitensor_tpu/models/loader.py).

Maps the HF Llama, GPT-2, BERT and OPT layouts onto the functional
layouts of models/llama.py, gpt2.py, bert.py and opt.py (torch's [out,
in] linear weights are transposed to [in, out]; GPT-2's Conv1D already is
[in, out]; OPT's q, k and v projections are fused into w_qkv). The source
is an in-memory state_dict, a directory of local .safetensors or torch
.bin shards, or one such file; nothing is fetched.
"""

from __future__ import annotations

import os

import torch

from infinitensor_tpu_torch.utils.platform import resolve_device


def _load_file(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors import safe_open   # optional: only at call time
        with safe_open(path, framework="pt") as fh:
            return {k: fh.get_tensor(k) for k in fh.keys()}
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_state_dict(path_or_sd) -> dict:
    if not isinstance(path_or_sd, (str, os.PathLike)):
        return dict(path_or_sd)
    path = str(path_or_sd)
    if os.path.isfile(path):
        return _load_file(path)
    files = sorted(os.listdir(path))
    shards = [f for f in files if f.endswith(".safetensors")] or \
        [f for f in files if f.endswith(".bin")]
    if not shards:
        raise FileNotFoundError(f"no checkpoint shards in {path}")
    sd = {}
    for f in shards:
        sd.update(_load_file(os.path.join(path, f)))
    return sd


def _t(sd, key, transpose=False, dtype=torch.bfloat16, device=None):
    """sd[key] through f32 (as the JAX loader reads it), transposed if
    asked, in `dtype` on `device`."""
    v = torch.as_tensor(sd[key]).detach().to("cpu").float()
    if transpose:
        v = v.t()
    return v.contiguous().to(dtype).to(device)


def load_llama_params(path_or_sd, cfg, dtype=None, prefix: str = "model.",
                      *, device=None) -> dict:
    """HF LlamaForCausalLM layout -> models/llama.py params (unfused
    wq/wk/wv, w_gate/w_up; a missing lm_head is tied to the embedding)."""
    device = resolve_device(device)
    sd = _load_state_dict(path_or_sd)
    dtype = dtype or cfg.dtype

    def t(key, transpose=False):
        return _t(sd, key, transpose, dtype, device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}layers.{i}."
        layers.append({
            "attn_norm": t(p + "input_layernorm.weight"),
            "wq": t(p + "self_attn.q_proj.weight", True),
            "wk": t(p + "self_attn.k_proj.weight", True),
            "wv": t(p + "self_attn.v_proj.weight", True),
            "wo": t(p + "self_attn.o_proj.weight", True),
            "mlp_norm": t(p + "post_attention_layernorm.weight"),
            "w_gate": t(p + "mlp.gate_proj.weight", True),
            "w_up": t(p + "mlp.up_proj.weight", True),
            "w_down": t(p + "mlp.down_proj.weight", True),
        })
    embed = t(f"{prefix}embed_tokens.weight")
    lm = t("lm_head.weight", True) if "lm_head.weight" in sd \
        else embed.t().contiguous()
    return {"embed": embed, "final_norm": t(f"{prefix}norm.weight"),
            "lm_head": lm, "layers": layers}


def load_gpt2_params(path_or_sd, cfg, dtype=None,
                     prefix: str = "transformer.", *, device=None) -> dict:
    """HF GPT2LMHeadModel layout -> models/gpt2.py params."""
    device = resolve_device(device)
    sd = _load_state_dict(path_or_sd)
    dtype = dtype or cfg.dtype

    def t(key):
        return _t(sd, key, False, dtype, device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}h.{i}."
        layers.append({
            "ln1_g": t(p + "ln_1.weight"), "ln1_b": t(p + "ln_1.bias"),
            "w_qkv": t(p + "attn.c_attn.weight"),
            "b_qkv": t(p + "attn.c_attn.bias"),
            "w_o": t(p + "attn.c_proj.weight"),
            "b_o": t(p + "attn.c_proj.bias"),
            "ln2_g": t(p + "ln_2.weight"), "ln2_b": t(p + "ln_2.bias"),
            "w_up": t(p + "mlp.c_fc.weight"), "b_up": t(p + "mlp.c_fc.bias"),
            "w_down": t(p + "mlp.c_proj.weight"),
            "b_down": t(p + "mlp.c_proj.bias"),
        })
    return {"wte": t(f"{prefix}wte.weight"), "wpe": t(f"{prefix}wpe.weight"),
            "lnf_g": t(f"{prefix}ln_f.weight"),
            "lnf_b": t(f"{prefix}ln_f.bias"), "layers": layers}


def load_bert_params(path_or_sd, cfg, dtype=torch.float32,
                     prefix: str = "", *, device=None) -> dict:
    """HF BertModel layout -> models/bert.py params."""
    device = resolve_device(device)
    sd = _load_state_dict(path_or_sd)

    def t(key, transpose=False):
        return _t(sd, key, transpose, dtype, device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}encoder.layer.{i}."
        a, o = p + "attention.", p + "output."
        layers.append({
            "wq": t(a + "self.query.weight", True),
            "bq": t(a + "self.query.bias"),
            "wk": t(a + "self.key.weight", True),
            "bk": t(a + "self.key.bias"),
            "wv": t(a + "self.value.weight", True),
            "bv": t(a + "self.value.bias"),
            "wo": t(a + "output.dense.weight", True),
            "bo": t(a + "output.dense.bias"),
            "ln1_g": t(a + "output.LayerNorm.weight"),
            "ln1_b": t(a + "output.LayerNorm.bias"),
            "w_up": t(p + "intermediate.dense.weight", True),
            "b_up": t(p + "intermediate.dense.bias"),
            "w_down": t(o + "dense.weight", True),
            "b_down": t(o + "dense.bias"),
            "ln2_g": t(o + "LayerNorm.weight"),
            "ln2_b": t(o + "LayerNorm.bias"),
        })
    e = f"{prefix}embeddings."
    return {"tok": t(e + "word_embeddings.weight"),
            "pos": t(e + "position_embeddings.weight"),
            "type": t(e + "token_type_embeddings.weight"),
            "emb_ln_g": t(e + "LayerNorm.weight"),
            "emb_ln_b": t(e + "LayerNorm.bias"), "layers": layers}


def load_opt_params(path_or_sd, cfg, dtype=None,
                    prefix: str = "model.decoder.", *, device=None) -> dict:
    """HF OPTForCausalLM layout -> models/opt.py params (q/k/v fused)."""
    device = resolve_device(device)
    sd = _load_state_dict(path_or_sd)
    dtype = dtype or cfg.dtype

    def t(key, transpose=False):
        return _t(sd, key, transpose, dtype, device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}layers.{i}."
        proj = [p + f"self_attn.{n}_proj." for n in ("q", "k", "v")]
        layers.append({
            "ln1_g": t(p + "self_attn_layer_norm.weight"),
            "ln1_b": t(p + "self_attn_layer_norm.bias"),
            "w_qkv": torch.cat([t(n + "weight", True) for n in proj], dim=1),
            "b_qkv": torch.cat([t(n + "bias") for n in proj]),
            "w_o": t(p + "self_attn.out_proj.weight", True),
            "b_o": t(p + "self_attn.out_proj.bias"),
            "ln2_g": t(p + "final_layer_norm.weight"),
            "ln2_b": t(p + "final_layer_norm.bias"),
            "w_up": t(p + "fc1.weight", True), "b_up": t(p + "fc1.bias"),
            "w_down": t(p + "fc2.weight", True), "b_down": t(p + "fc2.bias"),
        })
    return {"wte": t(f"{prefix}embed_tokens.weight"),
            "wpe": t(f"{prefix}embed_positions.weight"),
            "lnf_g": t(f"{prefix}final_layer_norm.weight"),
            "lnf_b": t(f"{prefix}final_layer_norm.bias"), "layers": layers}
