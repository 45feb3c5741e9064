"""Qwen2.5-VL model configuration (PyTorch/CUDA build).

A copy of `time_r1_tpu/models/qwen25vl/config.py`: the port imports nothing
from the JAX package, so it keeps its own dataclasses with the same fields.

Architecture parity target: the Qwen2.5-VL family as consumed by the reference
(`Qwen2_5_VLForConditionalGeneration.from_pretrained`, reference
timer1_trainer.py:244-251). Config fields mirror the public HF checkpoint
config.json keys so `from_hf_dict` can consume them directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    out_hidden_size: int = 2048
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        # flattened (C, temporal_patch, patch, patch) patch vector
        return self.in_channels * self.temporal_patch_size * self.patch_size * self.patch_size

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def window_patches(self) -> int:
        # window side length in merge units
        return self.window_size // self.spatial_merge_size // self.patch_size


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: tuple = (16, 24, 24)
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 128000
    use_sliding_window: bool = False
    sliding_window: Optional[int] = None
    max_window_layers: int = 70

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class Qwen25VLConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    bos_token_id: int = 151643
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643
    # stop ids used by the reference sampler (vllm_infer.py:112)
    stop_token_ids: tuple = (151645, 151643)

    @staticmethod
    def qwen25vl_3b() -> "Qwen25VLConfig":
        return Qwen25VLConfig()

    @staticmethod
    def qwen25vl_7b() -> "Qwen25VLConfig":
        return Qwen25VLConfig(
            vision=VisionConfig(out_hidden_size=3584),
            text=TextConfig(
                vocab_size=152064,
                hidden_size=3584,
                intermediate_size=18944,
                num_hidden_layers=28,
                num_attention_heads=28,
                num_key_value_heads=4,
                tie_word_embeddings=False,
            ),
        )

    @staticmethod
    def tiny_test(vocab_size: int = 256) -> "Qwen25VLConfig":
        """2-layer everything for CPU unit tests (SURVEY §7 test strategy)."""
        return Qwen25VLConfig(
            vision=VisionConfig(
                depth=2,
                hidden_size=32,
                intermediate_size=48,
                num_heads=2,
                out_hidden_size=64,
                fullatt_block_indexes=(1,),
            ),
            text=TextConfig(
                vocab_size=vocab_size,
                hidden_size=64,
                intermediate_size=96,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                mrope_section=(4, 2, 2),
                tie_word_embeddings=False,
            ),
            image_token_id=vocab_size - 4,
            video_token_id=vocab_size - 3,
            vision_start_token_id=vocab_size - 6,
            vision_end_token_id=vocab_size - 5,
            bos_token_id=0,
            eos_token_id=1,
            pad_token_id=0,
            stop_token_ids=(1,),
        )

    @staticmethod
    def from_hf_dict(d: dict) -> "Qwen25VLConfig":
        """Build from an HF checkpoint config.json dict (Qwen2.5-VL layout)."""
        v = d.get("vision_config", {})
        t = d.get("text_config", d)  # older configs inline text fields at top level
        rope_scaling = t.get("rope_scaling") or d.get("rope_scaling") or {}
        vision = VisionConfig(
            depth=v.get("depth", 32),
            hidden_size=v.get("hidden_size", 1280),
            intermediate_size=v.get("intermediate_size", 3420),
            num_heads=v.get("num_heads", 16),
            in_channels=v.get("in_channels", v.get("in_chans", 3)),
            patch_size=v.get("patch_size", 14),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            tokens_per_second=v.get("tokens_per_second", 2),
            window_size=v.get("window_size", 112),
            fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
            out_hidden_size=v.get("out_hidden_size", t.get("hidden_size", 2048)),
        )
        text = TextConfig(
            vocab_size=t.get("vocab_size", 151936),
            hidden_size=t.get("hidden_size", 2048),
            intermediate_size=t.get("intermediate_size", 11008),
            num_hidden_layers=t.get("num_hidden_layers", 36),
            num_attention_heads=t.get("num_attention_heads", 16),
            num_key_value_heads=t.get("num_key_value_heads", 2),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1000000.0),
            mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
            tie_word_embeddings=d.get("tie_word_embeddings", t.get("tie_word_embeddings", False)),
            max_position_embeddings=t.get("max_position_embeddings", 128000),
            use_sliding_window=t.get("use_sliding_window", False),
            sliding_window=t.get("sliding_window"),
            max_window_layers=t.get("max_window_layers", 70),
        )
        def tok(key, default):
            # token ids live at the top level in old-era configs and under
            # text_config in new-era (transformers ≥4.52) saves — check both
            return d.get(key, t.get(key, default))

        return Qwen25VLConfig(
            vision=vision,
            text=text,
            image_token_id=tok("image_token_id", 151655),
            video_token_id=tok("video_token_id", 151656),
            vision_start_token_id=tok("vision_start_token_id", 151652),
            vision_end_token_id=tok("vision_end_token_id", 151653),
            bos_token_id=tok("bos_token_id", 151643),
            eos_token_id=tok("eos_token_id", 151645),
            pad_token_id=tok("pad_token_id", 151643) or 151643,
        )

    def with_sliding_window(self, enabled: bool, window: int, max_window_layers: int) -> "Qwen25VLConfig":
        """Reference sliding-window knobs (main.py:51-60, timer1_trainer.py:247-249)."""
        return replace(
            self,
            text=replace(
                self.text,
                use_sliding_window=enabled,
                sliding_window=window,
                max_window_layers=max_window_layers,
            ),
        )
