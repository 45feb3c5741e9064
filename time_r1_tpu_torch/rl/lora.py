"""LoRA adapters (port of `time_r1_tpu/rl/lora.py`).

Adapters are a tree of their own beside the frozen base: for each adapted
weight an {"lora_a", "lora_b"} pair, merged functionally as
W + (alpha/r)·B@A. Training differentiates the loss in the adapters only;
the reference log-probs come from the unmerged base, which is peft's
disable_adapter() without a second copy of the model.

Layout. The port keeps one (out, in) weight per layer in a list of layer
dicts (`models/qwen25vl/convert.py`), so the adapter tree mirrors it: the
same nesting and the same lists, holding only the adapted weights, with

    lora_a: (r, in)    lora_b: (out, r)    delta = lora_b @ lora_a: (out, in)

so that one layer's delta adds straight onto that layer's weight. (The JAX
package stacks the layers and stores (in, out): lora_a (L, in, r), lora_b
(L, r, out); `convert.lora_from_jax` and `lora_to_jax` carry a tree across.)

    {"text": {"layers": [{"q_w": {...}, ..., "down_w": {...}}, ...]},
     "visual": {"blocks": [{"gate_w": {...}, "up_w": {...}, "down_w": {...}}, ...]}}

Over a decode-fused base (qkv, gu) the adapters keep per-projection names
(q_w, k_w, v_w; gate_w, up_w) with the widths of `fused_splits_for`, and a
merge concatenates their deltas along the output axis in the order in which
`ops/quant.py::quantize_text_params` concatenates the weights. Quantized
leaves ({"q8", "s"}) are seen by their q8 shape; int4 leaves have no training
layout and give nothing.

Over a sharded base (`parallel/sharding.py`) the adapters stay whole: a
merge takes the part of each that the rank's block of its weight needs
(`parallel/sharding.py::lora_block`; `merge_lora(shard=)` over the blocks,
`ShardContext.lora_local` inside a layer after its gather), and
`adapter_specs` gives the spec that says how each adapter's gradient is
summed over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..ops.quant import dequantize_weight, is_quantized, quantize_layer, quantize_text_params

DEFAULT_TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")

# component order of the decode-fused projections (ops/quant.py::quantize_text_params)
FUSED_ORDERS = {"qkv": ("q_w", "k_w", "v_w"), "gu": ("gate_w", "up_w")}


def fused_splits_for(text_cfg) -> dict:
    """Component widths of the decode-fused projections, keyed by fused name."""
    hd = text_cfg.head_dim
    return {
        "qkv": (
            ("q_w", text_cfg.num_attention_heads * hd),
            ("k_w", text_cfg.num_key_value_heads * hd),
            ("v_w", text_cfg.num_key_value_heads * hd),
        ),
        "gu": (("gate_w", text_cfg.intermediate_size), ("up_w", text_cfg.intermediate_size)),
    }


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _weight_shape(node) -> Optional[tuple]:
    """(out, in) of a plain 2-D weight or an int8 {q8, s} dict; None for an
    int4 dict (no training layout) and anything else."""
    if is_quantized(node):
        return tuple(node["q8"].shape) if "q8" in node else None
    if isinstance(node, torch.Tensor) and node.ndim == 2:
        return tuple(node.shape)
    return None


def _layer_targets(lp: dict, targets, fused_splits=None) -> list[tuple[str, tuple]]:
    """(adapter name, (out, in)) for each adaptable weight of one layer dict,
    in the order of `targets` whatever the base's layout."""
    out = []
    for name, node in lp.items():
        shape = _weight_shape(node)
        if shape is None:
            continue
        if fused_splits and name in fused_splits:
            comps = fused_splits[name]
            assert sum(w for _, w in comps) == shape[0], (name, shape, comps)
            out.extend((comp, (width, shape[1])) for comp, width in comps if comp in targets)
        elif name in targets:
            out.append((name, shape))
    return sorted(out, key=lambda t: targets.index(t[0]))


def _map_layers(tree, fn):
    """Apply fn to every layer dict of a params-shaped tree (an element of a
    list of dicts): returns the tree of fn's results, keeping only the
    subtrees where some result is non-empty, and whole lists."""
    if isinstance(tree, list):
        out = [fn(x) if isinstance(x, dict) else {} for x in tree]
        return out if any(out) else None
    if isinstance(tree, dict) and not is_quantized(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                sub = _map_layers(v, fn)
                if sub:
                    out[k] = sub
        return out
    return None


def init_lora(params: dict, cfg: LoRAConfig, seed: int = 0, dtype=torch.float32, fused_splits=None) -> dict:
    """The adapter tree over `params` (a whole {visual, text} tree or a part
    of one): lora_a ~ N(0, 0.02) drawn in tree order from one seeded
    torch.Generator on the weights' device, lora_b = 0, so the adapters start
    as the identity. fused_splits: `fused_splits_for(text_cfg)` over a
    decode-fused base."""
    targets = list(cfg.targets)
    gen = None

    def layer(lp: dict) -> dict:
        nonlocal gen
        out = {}
        for name, (fan_out, fan_in) in _layer_targets(lp, targets, fused_splits):
            ref = next(v for v in lp.values() if isinstance(v, torch.Tensor) or is_quantized(v))
            dev = (ref["s"] if is_quantized(ref) else ref).device
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
            a = torch.randn((cfg.rank, fan_in), generator=gen, device=dev, dtype=torch.float32) * 0.02
            out[name] = {"lora_a": a.to(dtype), "lora_b": torch.zeros((fan_out, cfg.rank), device=dev, dtype=dtype)}
        return out

    return _map_layers(params, layer) or {}


def lora_leaves(lora) -> list[torch.Tensor]:
    """The adapter tensors in tree order: what the optimizer updates."""
    if isinstance(lora, dict):
        return [x for v in lora.values() for x in lora_leaves(v)]
    if isinstance(lora, list):
        return [x for v in lora for x in lora_leaves(v)]
    return [lora]


def _delta(sl: dict, scaling: float) -> torch.Tensor:
    """scaling·B@A, (out, in), in the adapters' dtype."""
    return (sl["lora_b"] @ sl["lora_a"]) * scaling


def apply_layer_lora(lp: dict, lslice: Optional[dict], scaling: float) -> dict:
    """One layer's functional merge W + scaling·B@A, the math of `merge_lora`
    one layer at a time. Inside the loss's layer function (the unit that
    remat checkpoints) only this layer's merged weights exist, and the
    backward recomputes them.

    Quantized leaves dequantize to bf16 before the merge, one layer at a
    time, as the JAX package's do. Over a fused base (qkv, gu) the
    per-projection deltas are concatenated along the output axis and added to
    the fused weight."""
    if not lslice:
        return lp
    merged = dict(lp)
    for key, comps in FUSED_ORDERS.items():
        if key in lp and any(c in lslice for c in comps):
            missing = [c for c in comps if c not in lslice]
            assert not missing, f"fused base '{key}' needs adapters on all of {comps} (missing {missing})"
            base = dequantize_weight(lp[key]) if is_quantized(lp[key]) else lp[key]
            delta = torch.cat([_delta(lslice[c], scaling) for c in comps])
            merged[key] = base + delta.to(base.dtype)
    for name, sl in lslice.items():
        if name in lp:
            base = dequantize_weight(lp[name]) if is_quantized(lp[name]) else lp[name]
            merged[name] = base + _delta(sl, scaling).to(base.dtype)
    return merged


def merge_lora(params: dict, lora: dict, cfg: LoRAConfig, shard=None) -> dict:
    """The functionally merged tree: W + scaling·B@A at each adapted weight,
    every other leaf shared with `params`. A quantized base has no merged
    tree (it would not fit where it trains): use `apply_layer_lora` per layer
    (the loss) or `merge_quantize` (the rollout copy).

    shard (a `parallel/sharding.py::ShardContext` over `params`, whose leaves
    are this rank's blocks): each whole adapter is cut to its base leaf's
    block first (`lora_block`), so the merged tree is the rank's blocks of
    the merged model, and autograd takes the adapters' gradients through the
    model's gathers (the loss under context parallelism over a mesh)."""
    from ..parallel.sharding import Spec, lora_block

    def walk(node, sub, specs):
        if isinstance(node, list):
            return [walk(x, s, None if specs is None else sp)
                    for x, s, sp in zip(node, sub, specs if specs is not None else node)]
        if not any(isinstance(v, dict) and "lora_a" in v for v in sub.values()):
            return {k: walk(node[k], sub[k], None if specs is None else specs[k]) if k in sub else v
                    for k, v in node.items()}
        for key in sub:
            target = node.get(key, next((node.get(f) for f, c in FUSED_ORDERS.items() if key in c and f in node),
                                        None))
            if target is None:
                raise KeyError(key)
            if is_quantized(target):
                raise ValueError("merge_lora over a quantized base: merge per layer (apply_layer_lora) "
                                 "or merge and quantize (merge_quantize)")
        if specs is not None:
            sub = {k: lora_block(ab, specs.get(k, Spec(())), shard.sizes, shard.coords) for k, ab in sub.items()}
        return apply_layer_lora(node, sub, cfg.scaling)

    return walk(params, lora, None if shard is None else shard.specs)


def adapter_specs(lora, specs) -> list:
    """The spec of each adapter leaf's base leaf (`specs`, a spec tree over
    the base, `parallel/sharding.py::param_specs`), in `lora_leaves` order:
    how the leaf's gradient is reduced over a mesh (`rl/grpo.py::
    make_lora_train_step`). A decode-fused base's components ("qkv", "gu":
    no rule cuts them) take a whole leaf's spec."""
    from ..parallel.sharding import Spec

    if isinstance(lora, list):
        return [x for sub, sp in zip(lora, specs) for x in adapter_specs(sub, sp)]
    out = []
    for k, v in lora.items():
        if isinstance(v, dict) and "lora_a" in v:
            out += [specs.get(k, Spec(()))] * len(v)
        else:
            out += adapter_specs(v, specs[k])
    return out


def lora_layers_tree(lora: dict):
    """(the decoder layers' adapters: one dict per layer, or None; the rest).
    The decoder's adapters go into the layer functions (the loss's in-layer
    merge, the engines' side products); the rest (the ViT blocks' under
    fix_vit=False) merge conventionally."""
    return lora.get("text", {}).get("layers"), {k: v for k, v in lora.items() if k != "text"}


@torch.no_grad()
def merge_quantize(params: dict, lora: dict, cfg: LoRAConfig, bits: int = 8) -> dict:
    """`quantize_params(merge_lora(params, lora))` with the merged bf16 tree
    never whole: each decoder layer is merged and quantized in turn (the
    rollout copy of a bf16 base under rollout_quantization). The ViT's
    adapters, if any, merge conventionally (the vision tower stays as it is)."""
    dec, rest = lora_layers_tree(lora)
    text = params["text"]
    layers = []
    for li, lp in enumerate(text["layers"]):
        merged = apply_layer_lora(lp, dec[li] if dec else None, cfg.scaling)
        layers.append(quantize_layer(merged, bits=bits, fuse=True))
        del merged
    visual = merge_lora({"visual": params["visual"]}, {"visual": rest["visual"]}, cfg)["visual"] \
        if "visual" in rest else params["visual"]
    return {"visual": visual, "text": quantize_text_params(dict(text, layers=layers), bits=bits)}
