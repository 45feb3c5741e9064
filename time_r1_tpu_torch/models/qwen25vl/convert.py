"""Parameters of the port: bridge from/to the JAX param tree, and random init.

The port keeps plain dicts of tensors in torch's layout: linear weights are
(out, in) and every layer has its own dict in a list. The JAX tree stores
linear weights as (in, out) and stacks the layers on axis 0
(`time_r1_tpu/models/qwen25vl/language.py:14-20`, `vision.py:177-214`);
`params_from_jax` undoes both and `params_to_jax` redoes them.

    visual: patch_embed (hid, C·tp·ps²)
            blocks[i]: norm1 norm2 qkv_w qkv_b proj_w proj_b
                       gate_w gate_b up_w up_b down_w down_b
            merger: ln_q fc1_w fc1_b fc2_w fc2_b
    text:   embed_tokens (V, hid), norm (hid,), lm_head (V, hid) when untied
            layers[i]: input_layernorm post_attention_layernorm
                       q_w q_b k_w k_b v_w v_b o_w gate_w up_w down_w

Quantized trees (`ops/quant.py`) carry {"q8"|"q4", "s"} dicts in place of
weights, transposed like them (JAX's (K, N) values and (1, N) scales become
(N, K) and (N, 1)); decode-fused layers hold qkv, qkv_b and gu in place of
q/k/v and gate/up. The quantized embedding keeps its (V, H) layout; JAX's
int4 row marker `_row4` is dropped (the port packs every weight along its
last axis) and restored on the way back.

HF safetensors loading comes with the CLI slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .config import Qwen25VLConfig

# (path in the JAX tree, key in the port, stored transposed in JAX)
_VISION_BLOCK = [
    (("norm1", "scale"), "norm1", False),
    (("norm2", "scale"), "norm2", False),
    (("attn", "qkv_w"), "qkv_w", True),
    (("attn", "qkv_b"), "qkv_b", False),
    (("attn", "proj_w"), "proj_w", True),
    (("attn", "proj_b"), "proj_b", False),
    (("mlp", "gate_w"), "gate_w", True),
    (("mlp", "gate_b"), "gate_b", False),
    (("mlp", "up_w"), "up_w", True),
    (("mlp", "up_b"), "up_b", False),
    (("mlp", "down_w"), "down_w", True),
    (("mlp", "down_b"), "down_b", False),
]
_MERGER = [
    (("ln_q", "scale"), "ln_q", False),
    (("fc1", "kernel"), "fc1_w", True),
    (("fc1", "bias"), "fc1_b", False),
    (("fc2", "kernel"), "fc2_w", True),
    (("fc2", "bias"), "fc2_b", False),
]
_TEXT_NORMS = [
    (("input_layernorm", "scale"), "input_layernorm", False),
    (("post_attention_layernorm", "scale"), "post_attention_layernorm", False),
]
_ATTN_KEYS = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "qkv", "qkv_b")
_MLP_KEYS = ("gate_w", "up_w", "down_w", "gu")
_QKEYS = ("q8", "q4", "s")  # leaves of a quantized weight dict


def _text_layer_table(keys) -> list:
    """(path in the JAX tree, key in the port, transposed) for a text layer
    with these projection keys (plain, quantized, or decode-fused)."""
    table = list(_TEXT_NORMS)
    for key in keys:
        if key in _ATTN_KEYS or key in _MLP_KEYS:
            table.append((("self_attn" if key in _ATTN_KEYS else "mlp", key), key, not key.endswith("_b")))
    return table


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_from_jax(tree: dict, cfg: Qwen25VLConfig, device="cuda", dtype=torch.bfloat16) -> dict:
    """JAX param tree (numpy leaves) → the port's params on `device`."""
    device = resolve_device(device)

    def T(x, transpose: bool, keep_dtype: bool = False):
        if isinstance(x, dict):  # a quantized weight: values and scales keep their dtypes
            return {k: T(x[k], transpose, keep_dtype=True) for k in _QKEYS if k in x}
        a = np.asarray(x)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch view
            a = a.astype(np.float32)
        if transpose:
            a = np.swapaxes(a, -1, -2)
        # a copy: never aliases the JAX tree
        return torch.tensor(a, device=device, dtype=None if keep_dtype else dtype)

    def index(x, i: int):
        return {k: v[i] for k, v in x.items()} if isinstance(x, dict) else x[i]

    def layers(sub: dict, table, n: int) -> list:
        return [{key: T(index(_get(sub, path), i), tr) for path, key, tr in table} for i in range(n)]

    vis, txt = tree["visual"], tree["text"]
    visual = {
        "patch_embed": T(vis["patch_embed"]["kernel"], True),
        "blocks": layers(vis["blocks"], _VISION_BLOCK, cfg.vision.depth),
        "merger": {key: T(_get(vis["merger"], path), tr) for path, key, tr in _MERGER},
    }
    text = {
        "embed_tokens": T(txt["embed_tokens"]["embedding"], False),
        "layers": layers(txt["layers"], _text_layer_table([*txt["layers"]["self_attn"], *txt["layers"]["mlp"]]),
                         cfg.text.num_hidden_layers),
        "norm": T(txt["norm"]["scale"], False),
    }
    if "lm_head" in txt:
        text["lm_head"] = T(txt["lm_head"]["kernel"], True)
    return {"visual": visual, "text": text}


def params_to_jax(params: dict, cfg: Qwen25VLConfig) -> dict:
    """Inverse of params_from_jax: the port's params → JAX tree of numpy
    arrays ((in, out) weights, layers stacked on axis 0)."""

    def N(t, transpose: bool):
        if isinstance(t, dict):
            return {k: N(v, transpose) for k, v in t.items()}
        a = t.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        return np.ascontiguousarray(np.swapaxes(a, -1, -2) if transpose else a)

    def stack(leaves: list):
        if isinstance(leaves[0], dict):
            return {k: np.stack([x[k] for x in leaves]) for k in leaves[0]}
        return np.stack(leaves)

    def stacked(layer_list: list, table) -> dict:
        out: dict = {}
        for path, key, tr in table:
            _set(out, path, stack([N(lp[key], tr) for lp in layer_list]))
        return out

    def embedding(emb):
        e = N(emb, False)
        if isinstance(e, dict) and "q4" in e:
            e["_row4"] = np.ones((), np.int8)  # JAX's marker of a row-packed int4 table
        return e

    vis, txt = params["visual"], params["text"]
    merger: dict = {}
    for path, key, tr in _MERGER:
        _set(merger, path, N(vis["merger"][key], tr))
    visual = {
        "patch_embed": {"kernel": N(vis["patch_embed"], True)},
        "blocks": stacked(vis["blocks"], _VISION_BLOCK),
        "merger": merger,
    }
    text = {
        "embed_tokens": {"embedding": embedding(txt["embed_tokens"])},
        "layers": stacked(txt["layers"], _text_layer_table(txt["layers"][0])),
        "norm": {"scale": N(txt["norm"], False)},
    }
    if "lm_head" in txt:
        text["lm_head"] = {"kernel": N(txt["lm_head"], True)}
    return {"visual": visual, "text": text}


def init_params(cfg: Qwen25VLConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random weights drawn on `device` from a seeded torch.Generator, as the
    JAX init does: weights normal·0.02, norm scales 1, biases 0. (The numbers
    differ from the JAX init's: tests that compare the two packages bridge the
    JAX tree with params_from_jax instead.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def nrm(*shape) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02
        return w.to(dtype)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, device=device, dtype=dtype)

    v, t = cfg.vision, cfg.text
    hid, inter, merged = v.hidden_size, v.intermediate_size, v.hidden_size * v.merge_unit
    visual = {
        "patch_embed": nrm(hid, v.patch_input_dim),
        "blocks": [
            {
                "norm1": ones(hid), "norm2": ones(hid),
                "qkv_w": nrm(3 * hid, hid), "qkv_b": zeros(3 * hid),
                "proj_w": nrm(hid, hid), "proj_b": zeros(hid),
                "gate_w": nrm(inter, hid), "gate_b": zeros(inter),
                "up_w": nrm(inter, hid), "up_b": zeros(inter),
                "down_w": nrm(hid, inter), "down_b": zeros(hid),
            }
            for _ in range(v.depth)
        ],
        "merger": {
            "ln_q": ones(hid),
            "fc1_w": nrm(merged, merged), "fc1_b": zeros(merged),
            "fc2_w": nrm(v.out_hidden_size, merged), "fc2_b": zeros(v.out_hidden_size),
        },
    }
    H, nq, nkv = t.hidden_size, t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim
    text = {
        "embed_tokens": nrm(t.vocab_size, H),
        "layers": [
            {
                "input_layernorm": ones(H), "post_attention_layernorm": ones(H),
                "q_w": nrm(nq, H), "q_b": zeros(nq),
                "k_w": nrm(nkv, H), "k_b": zeros(nkv),
                "v_w": nrm(nkv, H), "v_b": zeros(nkv),
                "o_w": nrm(H, nq),
                "gate_w": nrm(t.intermediate_size, H),
                "up_w": nrm(t.intermediate_size, H),
                "down_w": nrm(H, t.intermediate_size),
            }
            for _ in range(t.num_hidden_layers)
        ],
        "norm": ones(H),
    }
    if not t.tie_word_embeddings:
        text["lm_head"] = nrm(t.vocab_size, H)
    return {"visual": visual, "text": text}
