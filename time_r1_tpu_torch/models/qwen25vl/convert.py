"""Parameters of the port: HF checkpoints, the port's native checkpoints, the
bridge from/to the JAX param tree, and random init.

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

HF checkpoints (`load_checkpoint`, `save_hf_checkpoint`) map straight into
this tree: torch's Linear layout is HF's, so only the names change (both HF
naming eras are read, the old one is written) and the Conv3d patch embed is
flattened. The port's own native checkpoint (what the trainer writes:
`timer1_config.json` beside `params.safetensors`, `utils/checkpoint.py`)
loads through the same `load_checkpoint`.

LoRA adapters cross between the packages through `lora_from_jax` /
`lora_to_jax`, and are stored as the JAX package stores them
(`save_lora_npz`, `load_lora_npz`: `lora_adapters.npz`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict

import numpy as np
import torch

from ...device import resolve_device
from ...ops.quant import is_quantized
from ...utils.safetensors_io import read_safetensors, write_safetensors
from .config import Qwen25VLConfig, TextConfig, VisionConfig

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


# ---------------------------------------------------------------------------
# LoRA adapters across the two packages. JAX keeps a flat dict keyed by the
# weight's path in its tree, {"text/layers/self_attn/q_w": {"lora_a": (L, in,
# r), "lora_b": (L, r, out)}, ...}; the port mirrors its own params
# (`rl/lora.py`): per layer, lora_a (r, in) and lora_b (out, r).
LORA_FILE = "lora_adapters.npz"


def _lora_sections(cfg: Qwen25VLConfig) -> dict:
    """(JAX path prefix) -> (port section, list key, layer count, {JAX
    (module, name): port key})."""
    text_keys = {(("self_attn" if k in _ATTN_KEYS else "mlp"), k): k for k in _ATTN_KEYS + _MLP_KEYS}
    vision_keys = {path: key for path, key, tr in _VISION_BLOCK if tr}
    return {"text/layers": ("text", "layers", cfg.text.num_hidden_layers, text_keys),
            "visual/blocks": ("visual", "blocks", cfg.vision.depth, vision_keys)}


def lora_from_jax(flat: dict, cfg: Qwen25VLConfig, device="cuda", dtype=torch.float32) -> dict:
    """The JAX package's adapter dict (numpy leaves) → the port's adapter tree
    on `device`: each layer's slice transposed."""
    device = resolve_device(device)
    out: dict = {}
    for path, ab in flat.items():
        parts = path.split("/")
        prefix = "/".join(parts[:2])
        if prefix not in _lora_sections(cfg) or len(parts) != 4:
            raise KeyError(f"no adapter layout for {path!r}")
        section, sub, n, keys = _lora_sections(cfg)[prefix]
        layers = out.setdefault(section, {}).setdefault(sub, [{} for _ in range(n)])
        a, b = np.asarray(ab["lora_a"], np.float32), np.asarray(ab["lora_b"], np.float32)
        for i in range(n):
            layers[i][keys[(parts[2], parts[3])]] = {
                "lora_a": torch.tensor(a[i].T, device=device, dtype=dtype),
                "lora_b": torch.tensor(b[i].T, device=device, dtype=dtype),
            }
    return out


def lora_to_jax(lora: dict, cfg: Qwen25VLConfig) -> dict:
    """The port's adapter tree → the JAX package's flat dict of stacked f32
    numpy arrays (lora_a (L, in, r), lora_b (L, r, out))."""
    flat = {}
    for prefix, (section, sub, _, keys) in _lora_sections(cfg).items():
        layers = lora.get(section, {}).get(sub)
        if not layers:
            continue
        path_of = {key: f"{prefix}/{mod}/{name}" for (mod, name), key in keys.items()}
        for key in layers[0]:
            flat[path_of[key]] = {
                n: np.stack([lp[key][n].detach().float().cpu().numpy().T for lp in layers])
                for n in ("lora_a", "lora_b")
            }
    return flat


def save_lora_npz(path: str, lora: dict, cfg: Qwen25VLConfig) -> None:
    """Write the adapters as the JAX package writes them: `{path}::lora_a`
    and `{path}::lora_b`, stacked f32 arrays, in one .npz (a file that either
    package loads)."""
    np.savez(path, **{f"{p}::{n}": v for p, ab in lora_to_jax(lora, cfg).items() for n, v in ab.items()})


def load_lora_npz(path: str) -> dict:
    """A `lora_adapters.npz` (written by either package) → the JAX package's
    flat adapter dict of f32 numpy arrays."""
    flat: dict = {}
    with np.load(path) as z:
        for key in z.files:
            p, n = key.split("::")
            flat.setdefault(p, {})[n] = np.asarray(z[key], np.float32)
    return flat


def init_params(cfg: Qwen25VLConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random weights drawn on `device` from a seeded torch.Generator, as the
    JAX init does: weights normal·0.02, norm scales 1, biases 0. (The numbers
    differ from the JAX init's: tests that compare the two packages bridge the
    JAX tree with params_from_jax instead.) On the `meta` device: the tree's
    shapes and dtypes only (the sharding plan of a full-size model)."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)

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


# ---------------------------------------------------------------------------
# HF checkpoints (port of `time_r1_tpu/models/qwen25vl/convert.py:38-278`)

HF_INDEX = "model.safetensors.index.json"


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory: the shards that
    `model.safetensors.index.json` names, or, without an index, every
    `*.safetensors` file. CPU tensors over copy-on-write mappings of the files
    (`utils/safetensors_io.py`)."""
    index = os.path.join(path, HF_INDEX)
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    out: Dict[str, torch.Tensor] = {}
    for name in files:
        out.update(read_safetensors(os.path.join(path, name)))
    return out


def _strip_prefixes(sd: Dict) -> Dict:
    """Normalize the two HF naming eras:
    old: visual.* / model.* / lm_head.*
    new (>=4.52): model.visual.* / model.language_model.* / lm_head.*
    → canonical: visual.* / model.* / lm_head.*"""
    out = {}
    for k, v in sd.items():
        nk = k
        if nk.startswith("model.visual."):
            nk = nk[len("model."):]
        elif nk.startswith("model.language_model."):
            nk = "model." + nk[len("model.language_model."):]
        elif nk.startswith("language_model.model."):
            nk = "model." + nk[len("language_model.model."):]
        out[nk] = v
    return out


# (HF name under visual.blocks.{i}. / model.layers.{i}., key in the port)
_HF_VISION_BLOCK = [
    ("norm1.weight", "norm1"), ("norm2.weight", "norm2"),
    ("attn.qkv.weight", "qkv_w"), ("attn.qkv.bias", "qkv_b"),
    ("attn.proj.weight", "proj_w"), ("attn.proj.bias", "proj_b"),
    ("mlp.gate_proj.weight", "gate_w"), ("mlp.gate_proj.bias", "gate_b"),
    ("mlp.up_proj.weight", "up_w"), ("mlp.up_proj.bias", "up_b"),
    ("mlp.down_proj.weight", "down_w"), ("mlp.down_proj.bias", "down_b"),
]
_HF_MERGER = [
    ("visual.merger.ln_q.weight", "ln_q"),
    ("visual.merger.mlp.0.weight", "fc1_w"), ("visual.merger.mlp.0.bias", "fc1_b"),
    ("visual.merger.mlp.2.weight", "fc2_w"), ("visual.merger.mlp.2.bias", "fc2_b"),
]
_HF_TEXT_LAYER = [
    ("input_layernorm.weight", "input_layernorm"),
    ("post_attention_layernorm.weight", "post_attention_layernorm"),
    ("self_attn.q_proj.weight", "q_w"), ("self_attn.q_proj.bias", "q_b"),
    ("self_attn.k_proj.weight", "k_w"), ("self_attn.k_proj.bias", "k_b"),
    ("self_attn.v_proj.weight", "v_w"), ("self_attn.v_proj.bias", "v_b"),
    ("self_attn.o_proj.weight", "o_w"),
    ("mlp.gate_proj.weight", "gate_w"), ("mlp.up_proj.weight", "up_w"), ("mlp.down_proj.weight", "down_w"),
]


def convert_state_dict(sd: Dict, cfg: Qwen25VLConfig, dtype=torch.bfloat16, device="cuda") -> dict:
    """The port's params from an HF state dict (torch tensors or numpy
    arrays, either naming era), cast to `dtype` on `device`. Each tensor is
    moved once, from wherever it lies (a mapped file) to its place."""
    device = resolve_device(device)
    sd = _strip_prefixes(sd)

    def T(key: str, fn: Callable = lambda x: x) -> torch.Tensor:
        x = sd[key]
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return fn(x).to(device=device, dtype=dtype, copy=True)

    v, t = cfg.vision, cfg.text
    visual = {
        "patch_embed": T("visual.patch_embed.proj.weight", lambda x: x.reshape(v.hidden_size, -1)),
        "blocks": [{key: T(f"visual.blocks.{i}.{name}") for name, key in _HF_VISION_BLOCK}
                   for i in range(v.depth)],
        "merger": {key: T(name) for name, key in _HF_MERGER},
    }
    text = {
        "embed_tokens": T("model.embed_tokens.weight"),
        "layers": [{key: T(f"model.layers.{i}.{name}") for name, key in _HF_TEXT_LAYER}
                   for i in range(t.num_hidden_layers)],
        "norm": T("model.norm.weight"),
    }
    if not t.tie_word_embeddings:
        text["lm_head"] = T("lm_head.weight" if "lm_head.weight" in sd else "model.embed_tokens.weight")
    return {"visual": visual, "text": text}


def export_state_dict(params: dict, cfg: Qwen25VLConfig) -> Dict[str, torch.Tensor]:
    """Inverse of convert_state_dict: the port's params → an HF state dict
    (old-era names: visual.* / model.* / lm_head.*) of views of the params,
    in their dtype and on their device. A tied head writes no lm_head."""
    v, t = cfg.vision, cfg.text
    vis, txt = params["visual"], params["text"]
    for leaf in (txt["layers"][0].get("q_w"), txt["embed_tokens"]):
        if leaf is None or is_quantized(leaf):
            raise ValueError("export_state_dict takes unquantized, unfused params (q_w/k_w/v_w, gate_w/up_w)")
    out: Dict[str, torch.Tensor] = {
        "visual.patch_embed.proj.weight": vis["patch_embed"].reshape(
            v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size),
    }
    for i, bp in enumerate(vis["blocks"]):
        out.update({f"visual.blocks.{i}.{name}": bp[key] for name, key in _HF_VISION_BLOCK})
    out.update({name: vis["merger"][key] for name, key in _HF_MERGER})
    out["model.embed_tokens.weight"] = txt["embed_tokens"]
    for i, lp in enumerate(txt["layers"]):
        out.update({f"model.layers.{i}.{name}": lp[key] for name, key in _HF_TEXT_LAYER})
    out["model.norm.weight"] = txt["norm"]
    if not t.tie_word_embeddings and "lm_head" in txt:
        out["lm_head.weight"] = txt["lm_head"]
    return out


def save_hf_checkpoint(path: str, params: dict, cfg: Qwen25VLConfig) -> int:
    """Write an HF-compatible `model.safetensors` (bf16, metadata format
    "pt", as transformers expects) into `path`; returns the bytes written.
    One tensor at a time crosses to the host."""
    os.makedirs(path, exist_ok=True)
    return write_safetensors(os.path.join(path, "model.safetensors"), export_state_dict(params, cfg),
                             {"format": "pt"}, dtype=torch.bfloat16)


def config_to_plain_dict(cfg: Qwen25VLConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_plain_dict(d: dict) -> Qwen25VLConfig:
    d = dict(d)
    vd = dict(d.pop("vision"))
    vd["fullatt_block_indexes"] = tuple(vd["fullatt_block_indexes"])
    td = dict(d.pop("text"))
    td["mrope_section"] = tuple(td["mrope_section"])
    d["stop_token_ids"] = tuple(d.get("stop_token_ids", (151645, 151643)))
    return Qwen25VLConfig(vision=VisionConfig(**vd), text=TextConfig(**td), **d)


def config_to_hf_dict(cfg: Qwen25VLConfig) -> dict:
    """An HF `config.json` dict (old-era layout: text fields at the top level)
    that `Qwen25VLConfig.from_hf_dict` reads back as `cfg`, but for the
    fields HF's config does not carry (stop_token_ids, the vision norm's
    eps) and a pad id of 0, which from_hf_dict reads as 151643."""
    v, t = cfg.vision, cfg.text
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "torch_dtype": "bfloat16",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
        "tie_word_embeddings": t.tie_word_embeddings,
        "max_position_embeddings": t.max_position_embeddings,
        "use_sliding_window": t.use_sliding_window,
        "sliding_window": t.sliding_window,
        "max_window_layers": t.max_window_layers,
        "hidden_act": "silu",
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads, "in_channels": v.in_channels, "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size, "temporal_patch_size": v.temporal_patch_size,
            "tokens_per_second": v.tokens_per_second, "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes), "out_hidden_size": v.out_hidden_size,
            "hidden_act": "silu",
        },
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
    }


NATIVE_CONFIG = "timer1_config.json"


def load_checkpoint(path: str, dtype=torch.bfloat16, device="cuda") -> tuple[dict, Qwen25VLConfig]:
    """A Qwen2.5-VL checkpoint directory → (params on `device`, config).

    Either format:
    - HF: config.json + *.safetensors (the published checkpoints);
    - native: timer1_config.json + params.safetensors (what the port's
      trainer writes, `utils/checkpoint.py`). Quantized {q8|q4, s} dicts keep
      their dtypes; every other leaf is cast to `dtype`.
    A JAX package's native checkpoint (an orbax `params/` directory) is
    refused with an error that names it."""
    from ...utils.checkpoint import is_native_checkpoint, load_params, refuse_orbax

    device = resolve_device(device)
    if os.path.exists(os.path.join(path, NATIVE_CONFIG)):
        refuse_orbax(path)
        if is_native_checkpoint(path):
            with open(os.path.join(path, NATIVE_CONFIG)) as f:
                cfg = config_from_plain_dict(json.load(f))
            return load_params(path, device=device, dtype=dtype), cfg
    with open(os.path.join(path, "config.json")) as f:
        cfg = Qwen25VLConfig.from_hf_dict(json.load(f))
    return convert_state_dict(load_safetensors_dir(path), cfg, dtype, device), cfg
