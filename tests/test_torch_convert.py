"""The port's HF checkpoint loader and exporter (`models/qwen25vl/convert.py`)
and its own safetensors reader and writer (`utils/safetensors_io.py`), on
the CPU, against the `safetensors` and `transformers` packages and the JAX
package's converter:

- the reader on files that `safetensors` writes (every dtype it takes, 0-d
  and empty tensors), and on a tiny HF model's sharded `save_pretrained`
  output with its index; the writer's output read by `safe_open`;
- `convert_state_dict` of both HF naming eras, in f32 and bf16, equal bit for
  bit to `params_from_jax` of the JAX package's `convert_state_dict`;
  `load_checkpoint` of the HF directory equal in both packages;
- `export_state_dict` inverse to the converter and equal to JAX's; a tied
  head writes no lm_head; `save_hf_checkpoint`'s output loaded by
  transformers' `from_pretrained` with every weight equal;
- the native checkpoint through `load_checkpoint`, an orbax directory refused
  by name, and the config dicts (`config_to_hf_dict` read back by
  `from_hf_dict`, the plain dicts equal to JAX's)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_model_parity import hf_model  # noqa: F401 (the tiny HF model fixture)
from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.models.qwen25vl import convert as jconv
from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, params_from_jax
from time_r1_tpu_torch.models.qwen25vl import convert as conv
from time_r1_tpu_torch.utils import checkpoint as ck
from time_r1_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors

torch.set_num_threads(2)

ALL_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.uint8, torch.int32, torch.int64,
              torch.bool]


def _tensors():
    g = torch.Generator().manual_seed(0)
    out = {"odd": torch.ones(3, dtype=torch.int8)}  # the writer keeps this order: what follows is misaligned
    for i, dt in enumerate(ALL_DTYPES):
        x = torch.randn(3, 5, generator=g) * 50
        out[f"t{i}"] = x > 0 if dt == torch.bool else x.to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    return out


def test_reader_reads_what_safetensors_writes(tmp_path):
    from safetensors.torch import save_file

    want = _tensors()
    save_file(want, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = read_safetensors(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    got["t2"].add_(1)  # a copy-on-write view: the file is unchanged
    assert torch.equal(read_safetensors(str(tmp_path / "a.safetensors"))["t2"], want["t2"])


def test_writer_output_read_by_safe_open(tmp_path):
    from safetensors import safe_open

    want = _tensors()
    path = str(tmp_path / "b.safetensors")
    nbytes = write_safetensors(path, want, {"format": "pt"})
    assert nbytes == os.path.getsize(path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"} and set(f.keys()) == set(want)
        for k in want:
            assert torch.equal(f.get_tensor(k), want[k]), k
    assert all(torch.equal(v, want[k]) for k, v in read_safetensors(path).items())


def _new_era(hf):
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


def _old_era(sd):
    """transformers ≥ 4.52 saves model.visual.* / model.language_model.*; the
    published checkpoints use visual.* / model.*."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.visual."):
            k = k[len("model."):]
        elif k.startswith("model.language_model."):
            k = "model." + k[len("model.language_model."):]
        out[k] = v
    return out


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("era", ["new", "old"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convert_state_dict_matches_jax_bit_for_bit(hf_model, era, dtype):  # noqa: F811
    sd = _new_era(hf_model)
    assert any(k.startswith("model.language_model.") for k in sd)
    if era == "old":
        sd = _old_era(sd)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = params_from_jax(jax.tree.map(np.asarray, jconv.convert_state_dict(sd, JCFG, dtype=jdtype)), CFG,
                           device="cpu", dtype=dtype)
    _assert_trees_equal(conv.convert_state_dict(sd, CFG, dtype=dtype, device="cpu"), want)


def test_sharded_save_pretrained_loads_equal_in_both_packages(hf_model, tmp_path):  # noqa: F811
    hf_model.save_pretrained(str(tmp_path), max_shard_size="100KB")
    files = os.listdir(tmp_path)
    assert conv.HF_INDEX in files and sum(f.endswith(".safetensors") for f in files) > 1
    got, cfg = conv.load_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    jparams, jcfg = jconv.load_checkpoint(str(tmp_path), dtype=jnp.float32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(got, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                                             dtype=torch.float32))
    sd = conv.load_safetensors_dir(str(tmp_path))  # save_pretrained writes the old era's names
    assert set(sd) == set(_old_era(_new_era(hf_model)))


def test_export_inverts_convert_and_matches_jax(hf_model):  # noqa: F811
    sd = _old_era(_new_era(hf_model))
    tp = conv.convert_state_dict(sd, CFG, dtype=torch.float32, device="cpu")
    out = conv.export_state_dict(tp, CFG)
    assert set(out) == set(sd)
    for k, v in out.items():
        assert torch.equal(v, sd[k]), k
    jout = jconv.export_state_dict(jconv.convert_state_dict(sd, JCFG, dtype=jnp.float32), JCFG)
    assert set(jout) == set(out)
    for k, v in jout.items():
        assert np.array_equal(out[k].numpy(), v), k


def test_tied_head_writes_no_lm_head():
    tied = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, tie_word_embeddings=True))
    tp = port_params(jax_params())
    assert "lm_head.weight" in conv.export_state_dict(tp, CFG)
    assert "lm_head.weight" not in conv.export_state_dict(tp, tied)


def test_transformers_loads_the_port_checkpoint(hf_model, tmp_path):  # noqa: F811
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLForConditionalGeneration

    tp = conv.convert_state_dict(_new_era(hf_model), CFG, dtype=torch.float32, device="cpu")
    nbytes = conv.save_hf_checkpoint(str(tmp_path), tp, CFG)
    hf_model.config.save_pretrained(str(tmp_path))
    assert nbytes == os.path.getsize(tmp_path / "model.safetensors")
    loaded = Qwen2_5_VLForConditionalGeneration.from_pretrained(str(tmp_path), torch_dtype=torch.bfloat16)
    got, want = loaded.state_dict(), _new_era(hf_model)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(torch.bfloat16)), k
    back, _ = conv.load_checkpoint(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    _assert_trees_equal(back, jax.tree.map(lambda t: t.to(torch.bfloat16), tp))


def test_native_checkpoint_loads_and_orbax_is_refused(tmp_path):
    from time_r1_tpu.utils.checkpoint import save_params as jax_save_params

    tp = port_params(jax_params())
    ck.save_params(str(tmp_path / "port"), tp)
    (tmp_path / "port" / conv.NATIVE_CONFIG).write_text(json.dumps(conv.config_to_plain_dict(CFG)))
    got, cfg = conv.load_checkpoint(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    assert cfg == CFG
    _assert_trees_equal(got, tp)
    got16, _ = conv.load_checkpoint(str(tmp_path / "port"), device="cpu")
    assert got16["text"]["norm"].dtype == torch.bfloat16

    jax_save_params(str(tmp_path / "jax"), jax_params())
    (tmp_path / "jax" / conv.NATIVE_CONFIG).write_text(json.dumps(jconv.config_to_plain_dict(JCFG)))
    with pytest.raises(ValueError, match="orbax"):
        conv.load_checkpoint(str(tmp_path / "jax"), device="cpu")


@pytest.mark.parametrize("name", ["qwen25vl_3b", "qwen25vl_7b"])
def test_config_dicts_round_trip(name):
    cfg = getattr(Qwen25VLConfig, name)()
    assert Qwen25VLConfig.from_hf_dict(json.loads(json.dumps(conv.config_to_hf_dict(cfg)))) == cfg
    plain = json.loads(json.dumps(conv.config_to_plain_dict(cfg)))
    assert plain == json.loads(json.dumps(jconv.config_to_plain_dict(getattr(type(JCFG), name)())))
    assert conv.config_from_plain_dict(plain) == cfg
