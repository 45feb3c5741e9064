"""Parameter sharding rules: FSDP over "data", tensor parallelism over
"model" (port of `time_r1_tpu/parallel/sharding.py`).

The rule table is JAX's `PARAM_RULES` over the port's paths and layout:
linear weights are (out, in) here and (in, out) there, so JAX's
`P(None, D, M)` over a stacked (L, in, out) kernel is `(M, D)` over the
port's per-layer (out, in) weight: out over "model", in over "data". Biases,
norms and the (V, H) embedding keep JAX's order without the layer axis. As
JAX's `_divisible` does, an axis that does not divide a dim is dropped for
that leaf (which then stays whole along it).

A rank (d, m) holds its contiguous block of every leaf (`shard_params`),
with one exception: the vision tower's fused `qkv_w` / `qkv_b` ((3·1280,
1280) and (3·1280,)) are split per head. Rank m holds its heads' q, its
heads' k and its heads' v, in that order. The contiguous block of the fused
rows would cut through q|k|v, which GSPMD reshards around and Megatron-style
compute cannot; the split is a difference of layout that gives the same
results (ROADMAP §C).

Where tp is a multiple of the text kv heads (`parallel/tensor.py`), the k
and v weights and biases are cut into nkv parts over "model" and rank m
takes part m // r: each kv head is replicated on r = tp/nkv ranks
(`Spec.replicas`; `param_specs(..., kv_heads=nkv)`,
`ShardContext.with_kv_heads`). Gathering such a leaf takes one replica of
each head (`fsdp.gather_whole`), the clip's norm counts it once
(`global_sq_sum`), and the trainer sums the replicas' gradients over
`ShardContext.kv_group`.

Serving over a model group (`serving_params`, the tensor-parallel `Engine`
of eval, data 1) takes the rank's blocks of the decoder layers and of the
vision tower by the same table and keeps the embedding, the final norm and
the head whole. Quantized (int8 or int4), each projection is quantized
whole and then split, as JAX's `time_r1_tpu/parallel/pipeline.py:58-82`
states: a column-parallel weight (q, k, v, gate, up: output rows split)
takes its rows of q8 / q4 and of the per-row scales; a row-parallel one (o,
down: input columns split) takes its columns of q8, or its packed K/2 bytes
of q4, and keeps every scale whole, since each is a max over the split axis
(quantizing the local block would change it). The rank then fuses its own
q | k | v heads and gate | up columns into the "qkv" / "gu" leaves that
`attn_qkv_proj`, Q1 and Q2 take. The tree it returns is a `ServingTree`,
which records what it was cut for: an engine handed one (the paged and slot
engines over a TP engine's `params`) takes it as it is.

LoRA adapters stay whole on every rank. A layer merges the part of them
that its blocks need (`lora_block`, by the spec of the base leaf: lora_b's
rows where the leaf's dim 0 is cut, a replicated kv head's whole; lora_a's
columns where its dim 1 is), so the adapters' gradients on a rank are the
parts its blocks reach (`rl/grpo.py::lora_value_and_grad` sums them).

`ShardContext` carries a mesh's groups, sizes, this rank's coordinates and
the spec tree of the parameters it shards. The layer functions of the model
(`models/qwen25vl/language.py`, `vision.py`) take one: they gather a layer's
data shards just before use (`fsdp.py`) and run its model-local heads and
MLP width (`tensor.py`).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .comm import all_reduce_sum
from .mesh import DATA_AXIS as D
from .mesh import MODEL_AXIS as M

# (regex over the port's 'a/b/c' param path) → the axis of each dim. First
# match wins; no match replicates (small tensors, quantized leaves' q8/s).
PARAM_RULES: list[tuple[str, tuple]] = [
    # --- text decoder: (out, in) weights, one dict a layer ---
    (r"^text/layers/\d+/(q_w|k_w|v_w)$", (M, D)),
    (r"^text/layers/\d+/(q_b|k_b|v_b)$", (M,)),
    (r"^text/layers/\d+/o_w$", (D, M)),
    (r"^text/layers/\d+/(gate_w|up_w)$", (M, D)),
    (r"^text/layers/\d+/down_w$", (D, M)),
    (r"^text/layers/\d+/.*layernorm$", ()),
    (r"^text/embed_tokens$", (D, M)),
    (r"^text/lm_head$", (M, D)),
    (r"^text/norm$", ()),
    # --- vision tower ---
    (r"^visual/patch_embed$", (M, None)),
    (r"^visual/blocks/\d+/qkv_w$", (M, D)),
    (r"^visual/blocks/\d+/qkv_b$", (M,)),
    (r"^visual/blocks/\d+/proj_w$", (D, M)),
    (r"^visual/blocks/\d+/proj_b$", ()),
    (r"^visual/blocks/\d+/(gate_w|up_w)$", (M, D)),
    (r"^visual/blocks/\d+/(gate_b|up_b)$", (M,)),
    (r"^visual/blocks/\d+/down_w$", (D, M)),
    (r"^visual/blocks/\d+/down_b$", ()),
    (r"^visual/blocks/\d+/norm\d$", ()),
    (r"^visual/merger/ln_q$", ()),
    (r"^visual/merger/fc1_w$", (M, D)),
    (r"^visual/merger/fc1_b$", (M,)),
    (r"^visual/merger/fc2_w$", (D, M)),
    (r"^visual/merger/fc2_b$", ()),
    # LoRA adapters (rl/lora.py: lora_a (r, in), lora_b (out, r)): the hidden
    # dim like their base weight. In the table, unused: a LoRA trainer keeps
    # its adapters whole on every rank, and a layer merges the part of them
    # that its blocks need (`lora_block`; ROADMAP §C).
    (r"lora_a$", (None, D)),
    (r"lora_b$", (M, None)),
]

# the text k/v leaves: replicated over "model" where tp is a multiple of the kv heads (the module docstring)
KV_RULE = r"^text/layers/\d+/(k_w|v_w|k_b|v_b)$"

# fused leaves split per head over "model": (regex, parts along dim 0)
FUSED_RULES: list[tuple[str, int]] = [
    (r"^visual/blocks/\d+/qkv_(w|b)$", 3),
]


@dataclass(frozen=True)
class Spec:
    """How one leaf is sharded: the mesh axis of each dim (None: whole along
    it), and for a fused leaf the number of parts its dim 0 holds (q|k|v),
    each split over "model" on its own; for a replicated kv leaf the model
    ranks that hold each of its tp/replicas blocks."""

    dims: tuple
    parts: int = 1
    replicas: int = 1  # model ranks that hold the same block (replicated kv heads): rank m takes block m // replicas

    def axis_dim(self, axis: str) -> Optional[int]:
        """The dim sharded over `axis`, or None."""
        return self.dims.index(axis) if axis in self.dims else None


def spec_for_path(path: str) -> tuple:
    """The rule table's dims for a path (`()`, replicated, when none matches)."""
    for pattern, dims in PARAM_RULES:
        if re.search(pattern, path):
            return dims
    return ()


def fused_parts(path: str) -> int:
    for pattern, parts in FUSED_RULES:
        if re.search(pattern, path):
            return parts
    return 1


def _divisible(shape, dims: tuple, sizes: dict, parts: int = 1) -> tuple:
    """JAX's `_divisible`: drop an axis that does not divide its dim (a fused
    dim 0 must divide by parts·size)."""
    out = []
    for i, dim in enumerate(shape):
        ax = dims[i] if i < len(dims) else None
        if ax is None:
            out.append(None)
            continue
        size = sizes[ax]
        n = dim // parts if (i == 0 and parts > 1 and dim % parts == 0) else dim
        out.append(ax if n % size == 0 and n >= size else None)
    return tuple(out)


def mesh_sizes(mesh) -> dict:
    """{"data": n, "model": m} of a DeviceMesh, or of such a dict itself."""
    if isinstance(mesh, dict):
        return {D: int(mesh.get(D, 1)), M: int(mesh.get(M, 1))}
    return {ax: mesh.size(mesh.mesh_dim_names.index(ax)) for ax in (D, M)}


def _map(tree, fn, path: str = ""):
    """fn(path, leaf) over a tree of dicts and lists, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(tree: Any, mesh, kv_heads: Optional[int] = None) -> Any:
    """A tree of `Spec`s matching `tree` by the rule table (any device, the
    `meta` one too), with JAX's `_divisible` applied to each leaf's shape.
    kv_heads: the text's kv heads, whose k/v leaves are replicated where the
    model dim is a multiple of them (`replicated_kv`)."""
    sizes = mesh_sizes(mesh)

    def f(path, leaf):
        parts = fused_parts(path)
        spec = Spec(_divisible(tuple(leaf.shape), spec_for_path(path), sizes, parts), parts)
        return replicated_kv(spec, sizes[M], kv_heads) if kv_heads and re.search(KV_RULE, path) else spec

    return _map(tree, f)


def replicated_kv(spec: Spec, tp: int, nkv: int) -> Spec:
    """A k/v leaf's spec over a model dim of tp with nkv kv heads: as it is
    where tp divides nkv, else dim 0 cut into nkv heads over "model", each
    on tp/nkv ranks (the rows are nkv·head_dim, so the cut never splits a
    head)."""
    if tp <= nkv:
        return spec
    return Spec((M,) + tuple(spec.dims[1:]), spec.parts, tp // nkv)


def _heads_major(x: torch.Tensor, parts: int, n: int) -> torch.Tensor:
    """Dim 0 of a fused leaf reordered from (part, model rank, rows) to
    (model rank, part, rows): rank m's block is then contiguous."""
    rows = x.shape[0] // (parts * n)
    return x.reshape(parts, n, rows, *x.shape[1:]).transpose(0, 1).reshape(x.shape)


def _parts_major(x: torch.Tensor, parts: int, n: int) -> torch.Tensor:
    """`_heads_major`'s inverse."""
    rows = x.shape[0] // (parts * n)
    return x.reshape(n, parts, rows, *x.shape[1:]).transpose(0, 1).reshape(x.shape)


def _cut(x: torch.Tensor, spec: Spec, sizes: dict, coords: dict) -> torch.Tensor:
    """Rank `coords`' block of a whole leaf, as autograd sees it (no copy
    where a view will do)."""
    if spec.parts > 1 and spec.dims and spec.dims[0] == M:
        x = _heads_major(x, spec.parts, sizes[M])
    for i, ax in enumerate(spec.dims):
        if ax is not None:
            n = sizes[ax] // spec.replicas if ax == M else sizes[ax]
            x = x.chunk(n, dim=i)[coords[ax] // spec.replicas if ax == M else coords[ax]]
    return x


def shard_leaf(x: torch.Tensor, spec: Spec, sizes: dict, coords: dict) -> torch.Tensor:
    """Rank `coords`' block of a whole leaf (a new contiguous tensor)."""
    return _cut(x, spec, sizes, coords).detach().clone(memory_format=torch.contiguous_format)


def lora_block(adapter: dict, spec: Spec, sizes: dict, coords: dict) -> dict:
    """The part of a whole adapter pair ({lora_a (r, in), lora_b (out, r)},
    `rl/lora.py`) that gives rank `coords`' block of its delta B@A, by the
    spec of its base leaf (`spec`, which cut that leaf): lora_b's rows by the
    spec's dim 0 (a column-parallel weight's heads or width, a fused leaf's
    q | k | v per head, a replicated kv head whole) and lora_a's columns by
    its dim 1 (a row-parallel weight's). B_block @ A_block is then the block
    of B@A, element for element. Differentiable: the adapters' gradients
    reach only their cut parts. `sizes` with "data" 1 gives the model-local
    form that a layer merges into after its FSDP gather (`ShardContext.lora_local`)."""
    dims = tuple(spec.dims) + (None,) * (2 - len(spec.dims))
    return {"lora_a": _cut(adapter["lora_a"], Spec((None, dims[1])), sizes, coords),
            "lora_b": _cut(adapter["lora_b"], Spec((dims[0], None), spec.parts, spec.replicas), sizes, coords)}


def splits_over_model(spec: Spec, tp: int) -> bool:
    """Whether a leaf of this spec is cut over a model dim of tp (a
    replicated kv leaf is): its blocks differ from one model rank to the
    next, and so do the parts of an adapter's gradient that they reach."""
    return tp > 1 and M in spec.dims


def shard_params(tree: Any, mesh, coords: Optional[dict] = None, specs: Any = None) -> Any:
    """This rank's blocks of every leaf of a whole tree, by the rule table
    (`coords` {"data": d, "model": m}: another rank's; defaults to this
    process's coordinates on the mesh)."""
    sizes = mesh_sizes(mesh)
    if coords is None:
        coords = {ax: mesh.get_local_rank(ax) for ax in (D, M)}
    specs = param_specs(tree, mesh) if specs is None else specs
    return _zip(tree, specs, lambda x, s: shard_leaf(x, s, sizes, coords))


def _zip(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip(v, s, fn) for v, s in zip(tree, specs)]
    return fn(tree, specs)


@dataclass
class ShardContext:
    """A mesh's groups and sizes, this rank's coordinates and the spec tree
    of the parameters (or the subtree `at` selects). Passed to the model's
    layer functions, the loss and the optimizer's clip. kv_heads: the text's
    kv heads its specs replicate where tp is a multiple of them (0: not
    recorded, nothing replicated); kv_group: the process group of this
    rank's kv-head replicas (`mesh.kv_replica_group`, the trainer's), over
    which their gradients are summed."""

    data_group: Any
    model_group: Any
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    specs: Any
    kv_heads: int = 0
    kv_group: Any = None

    @staticmethod
    def build(mesh, params) -> "ShardContext":
        """The context of `mesh` over a whole tree shaped like `params`."""
        from .mesh import data_group, model_group

        sizes = mesh_sizes(mesh)
        return ShardContext(data_group(mesh), model_group(mesh), sizes[D], sizes[M], mesh.get_local_rank(D),
                            mesh.get_local_rank(M), param_specs(params, mesh))

    def with_kv_heads(self, nkv: int) -> "ShardContext":
        """The same context with the text's k/v specs replicated for nkv kv
        heads (`replicated_kv`; where tp divides nkv they are unchanged):
        how the trainer and the engines make a context their model's. A
        context that recorded them is returned as it is."""
        if self.kv_heads:
            if self.kv_heads != nkv:
                raise ValueError(f"a shard context built for {self.kv_heads} kv heads handed to a model of {nkv}")
            return self
        specs = self.specs
        if isinstance(specs, dict) and isinstance(specs.get("text"), dict) and "layers" in specs["text"]:
            layers = [{k: replicated_kv(s, self.tp, nkv) if k in ("k_w", "v_w", "k_b", "v_b") else s
                       for k, s in lp.items()} for lp in specs["text"]["layers"]]
            specs = dict(specs, text=dict(specs["text"], layers=layers))
        return dataclasses.replace(self, specs=specs, kv_heads=nkv)

    @property
    def sizes(self) -> dict:
        return {D: self.dp, M: self.tp}

    @property
    def coords(self) -> dict:
        return {D: self.data_rank, M: self.model_rank}

    def at(self, *keys) -> "ShardContext":
        """The same context over a subtree of the specs."""
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return dataclasses.replace(self, specs=specs)

    def shard(self, tree: Any) -> Any:
        """This rank's blocks of a whole tree shaped like the specs."""
        return shard_params(tree, self.sizes, self.coords, self.specs)

    def layer(self, lp: dict, li: Optional[int] = None, key: Optional[str] = None) -> dict:
        """A layer dict gathered over "data" (`fsdp.gather_layer`): each leaf
        in its model-local form. The specs are `specs[key][li]`, or the
        context's own."""
        from .fsdp import gather_layer

        specs = self.specs if key is None else self.specs[key]
        return gather_layer(lp, specs if li is None else specs[li], self)

    def lora_local(self, adapters: Optional[dict], specs: dict) -> Optional[dict]:
        """One layer's whole adapters ({name: {lora_a, lora_b}}) cut to the
        rank's model-local blocks of their base leaves (`lora_block` at data
        1: the layer's leaves are gathered over "data" before the merge), by
        the layer's specs `specs`. An adapter whose base leaf has no spec of
        its own (a decode-fused "qkv" / "gu": no rule cuts it) stays whole."""
        if not adapters:
            return adapters
        sizes, coords = {D: 1, M: self.tp}, {D: 0, M: self.model_rank}
        return {k: lora_block(ab, specs.get(k, Spec(())), sizes, coords) for k, ab in adapters.items()}

    def whole(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """Leaf `key` gathered whole on every rank (`fsdp.gather_whole`)."""
        from .fsdp import gather_whole

        return gather_whole(x, self.specs[key], self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product (`tensor.copy_to_model`)."""
        from .tensor import copy_to_model

        return x if self.tp == 1 else copy_to_model(x, self.model_group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product (`tensor.reduce_from_model`)."""
        from .tensor import reduce_from_model

        return y if self.tp == 1 else reduce_from_model(y, self.model_group)


def global_sq_sum(blocks: list, specs: list, shard: ShardContext) -> torch.Tensor:
    """Σ x² over the whole leaves that `blocks` (this rank's, one per spec)
    belong to, as an f32 0-d tensor equal on every rank: the blocks of a leaf
    sharded over an axis are summed over its group, and a leaf whole along an
    axis (the same on every rank of it) is counted once, as is a replicated
    kv block (only the first of its replicas adds it)."""
    dev = blocks[0].device if blocks else torch.device("cpu")
    by = {(d, m): torch.zeros((), dtype=torch.float32, device=dev) for d in (False, True) for m in (False, True)}
    for x, s in zip(blocks, specs):
        if shard.model_rank % s.replicas:
            continue
        key = (D in s.dims and shard.dp > 1, M in s.dims and shard.tp > 1)
        by[key] = by[key] + x.float().pow(2).sum()
    if shard.dp > 1:
        part = torch.stack([by[(True, False)], by[(True, True)]])
        all_reduce_sum([part], shard.data_group)
        by[(True, False)], by[(True, True)] = part[0], part[1]
    if shard.tp > 1:
        part = torch.stack([by[(False, True)], by[(True, True)]])
        all_reduce_sum([part], shard.model_group)
        by[(False, True)], by[(True, True)] = part[0], part[1]
    return by[(False, False)] + by[(True, False)] + by[(False, True)] + by[(True, True)]


@torch.no_grad()
def serving_layer(lp: dict, tp: int, m: int, bits: int = 0, device=None, kv_heads: Optional[int] = None) -> dict:
    """Model rank m's serving form of one whole decoder layer (the port's
    unfused per-layer dict): its blocks by the rule table (`shard_leaf` at
    data 1); with bits 8 or 4 each projection quantized whole, its q8 (or
    packed q4, split along the bytes: two k a byte) split as the weight and
    its per-output-row scales as the weight's dim 0 (split for the
    column-parallel leaves, whole for the row-parallel ones: the module
    docstring), and the rank's q | k | v and gate | up then fused
    (`ops/quant.py::quantize_layer`). `device`: where the leaves go (the
    quantization runs there). kv_heads: the text's kv heads; where tp is a
    multiple of them the rank takes its whole replicated kv head
    (`replicated_kv`), rows and scales alike."""
    from ..ops.quant import is_quantized, quantize_layer, quantize_weight

    if "qkv" in lp or "gu" in lp or any(is_quantized(v) for v in lp.values()):
        raise ValueError("serving shards are cut from an unquantized, unfused tree")
    if bits not in (0, 8, 4):
        raise ValueError(f"serving weights are bf16, int8 or int4, not {bits} bits")
    sizes, coords = {D: 1, M: tp}, {D: 0, M: m}
    specs = param_specs({"text": {"layers": [lp]}}, sizes, kv_heads)["text"]["layers"][0]
    key = "q8" if bits == 8 else "q4"

    def cut(x: torch.Tensor, spec: Spec):
        x = x.detach()
        if not (bits and x.dim() == 2):
            return shard_leaf(x, spec, sizes, coords).to(device if device is not None else x.device)
        q = quantize_weight(x.to(device if device is not None else x.device), bits)  # whole, where the blocks go
        split = spec.axis_dim(M)
        if split is not None and q[key].shape[split] % tp:  # int4 over K/2 bytes: a byte holds two k
            raise ValueError(f"a {tuple(q[key].shape)} {key} leaf cannot split over {tp} model ranks")
        return {key: shard_leaf(q[key], spec, sizes, coords),
                "s": shard_leaf(q["s"], Spec(spec.dims[:1], replicas=spec.replicas), sizes, coords)}

    out = {k: cut(v, specs[k]) for k, v in lp.items()}
    return quantize_layer(out, bits=bits, fuse=True) if bits else out


class ServingTree(dict):
    """A rank's serving tree ({visual, text}, `serving_params`), which also
    records what it was cut for: the model group's size `tp`, the model rank
    and the weights' bits (0: unquantized)."""

    def __init__(self, tree: dict, tp: int, model_rank: int, bits: int):
        super().__init__(tree)
        self.tp, self.model_rank, self.bits = tp, model_rank, bits

    def check(self, shard: "ShardContext", bits: Optional[int]) -> None:
        """Refuse a tree cut for another rank, or at other bits than `bits`
        (None: any)."""
        if (self.tp, self.model_rank) != (shard.tp, shard.model_rank):
            raise ValueError(f"a serving tree of model rank {self.model_rank} of {self.tp} handed to model rank "
                             f"{shard.model_rank} of {shard.tp}")
        if bits is not None and bits != self.bits:
            raise ValueError(f"a serving tree of {self.bits}-bit weights where {bits} bits were asked (0: none)")


@torch.no_grad()
def serving_params(params: dict, shard: "ShardContext", bits: int = 0, device=None) -> ServingTree:
    """This rank's serving tree from a whole {visual, text} tree on a mesh
    of data 1 (the eval mesh): `serving_layer` for each decoder layer, the
    rank's blocks of the vision tower by the rule table, and the embedding,
    the final norm and the head whole (int8 under bits 8 and 4, as
    `ops/quant.py::quantize_text_params` has them). Every leaf goes to
    `device`. FSDP (data > 1) raises NotImplementedError (A13)."""
    from ..ops.quant import quantize_text_params

    if shard.dp != 1:
        raise NotImplementedError("a serving engine over FSDP shards (data > 1) is not ported (ROADMAP A13)")

    def to(x):
        return x.detach().to(device if device is not None else x.device)

    text = {k: to(v) for k, v in params["text"].items() if k != "layers"}
    text = quantize_text_params(dict(text, layers=[]), bits=bits) if bits else text
    text["layers"] = [serving_layer(lp, shard.tp, shard.model_rank, bits, device, shard.kv_heads or None)
                      for lp in params["text"]["layers"]]
    vis = shard.at("visual")
    visual = _zip(params["visual"], vis.specs, lambda x, sp: shard_leaf(to(x), sp, vis.sizes, vis.coords))
    return ServingTree({"visual": visual, "text": text}, shard.tp, shard.model_rank, bits)


def serving_context(shard: "ShardContext", layers: list) -> "ShardContext":
    """The context a serving tree's decoder takes (`decoder_forward(shard=)`):
    the model group and rank of `shard`, and a spec over each leaf of the
    serving layers `layers` that gathers nothing (data 1: each is already
    the rank's model-local form)."""
    return dataclasses.replace(shard, specs={"layers": [{k: Spec(()) for k in lp} for lp in layers]})


@torch.no_grad()
def gather_params(tree: Any, shard: ShardContext, keep: bool = True, text_layer=None, to=None) -> Any:
    """The whole tree from every rank's blocks (`fsdp.gather_whole`, leaf by
    leaf; every rank of the mesh calls it together). keep=False: this rank
    takes part in the collectives and keeps nothing (returns None).
    text_layer(layer dict, layer index): applied to each gathered text layer
    dict before the next is gathered (the rollout copy's adapter merge and
    quantization: one bf16 layer whole at a time). to: a device for the kept leaves (the CPU for a save). A leaf
    that is whole on every rank is returned as it is, not copied."""
    import torch.distributed as dist

    from .fsdp import gather_whole

    group = shard.data_group if shard.data_group is not None else shard.model_group
    nccl = group is not None and dist.get_backend(group) == "nccl"

    def whole(x, spec):
        if nccl and not x.is_cuda:  # an offloaded optimizer leaf: NCCL moves device tensors only
            x = x.to(torch.device("cuda", torch.cuda.current_device()))
        x = gather_whole(x, spec, shard)
        return None if not keep else (x if to is None else x.to(to))

    def walk(sub, specs, path):
        if isinstance(sub, dict):
            if path.startswith("text/layers/") and text_layer is not None:
                lp = {k: whole(v, specs[k]) for k, v in sub.items()}
                return text_layer(lp, int(path.rsplit("/", 1)[1])) if keep else None
            return {k: walk(v, specs[k], f"{path}/{k}" if path else k) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return [walk(v, s, f"{path}/{i}") for i, (v, s) in enumerate(zip(sub, specs))]
        return whole(sub, specs)

    out = walk(tree, shard.specs, "")
    return out if keep else None
