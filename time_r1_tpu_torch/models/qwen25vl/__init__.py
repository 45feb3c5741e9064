"""Qwen2.5-VL in PyTorch (port of `time_r1_tpu/models/qwen25vl/`)."""

from .config import Qwen25VLConfig, TextConfig, VisionConfig
from .convert import init_params, params_from_jax, params_to_jax
from .language import (
    KVCache,
    decoder_forward,
    lm_logits,
    mrope_cos_sin,
    shared_decode_forward,
    suffix_cache_zeros,
)
from .model import VisionInputs, forward, forward_shared_decode, merge_vision_embeddings
from .rope import get_rope_index
from .vision import VisionPrep, prepare_vision_inputs, vision_forward

__all__ = [
    "KVCache",
    "Qwen25VLConfig",
    "TextConfig",
    "VisionConfig",
    "VisionInputs",
    "VisionPrep",
    "decoder_forward",
    "forward",
    "forward_shared_decode",
    "get_rope_index",
    "init_params",
    "lm_logits",
    "merge_vision_embeddings",
    "mrope_cos_sin",
    "params_from_jax",
    "params_to_jax",
    "prepare_vision_inputs",
    "shared_decode_forward",
    "suffix_cache_zeros",
    "vision_forward",
]
