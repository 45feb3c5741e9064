"""The port's processor (`time_r1_tpu_torch/models/processor.py`) against the
JAX package's, mirroring tests/test_processor.py:

- the chat template bit-equal over the message shapes the pipeline makes;
- the native patchify bit-equal to JAX's and to the port's numpy plain
  version (odd T, no rescale, no normalize), and within 1e-5 of HF's
  Qwen2VLImageProcessor;
- `Qwen25VLProcessor.__call__` over tests/tiny_tokenizer.py equal to JAX's
  in every field (ids, mask, patches bit-equal, grids, seconds per grid),
  video-token expansion and padding on both sides;
- a tokenizer's own chat template wins; `from_pretrained` over a tokenizer
  saved locally; `decode` and `batch_decode`."""

import numpy as np
import pytest

from test_torch_video import jax_native_libs
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.models import processor as jproc
from time_r1_tpu_torch.models import processor as proc


@pytest.fixture(scope="module", autouse=True)
def jax_libs():
    jax_native_libs()


MESSAGES = [
    [{"role": "user", "content": [{"type": "text", "text": "Find the event."}, {"type": "video", "video": "x.mp4"}]}],
    [{"role": "system", "content": "You are a video analysis expert."},
     {"role": "user", "content": [{"type": "video", "video": "v"}, {"type": "text", "text": "q?"}]}],
    [{"role": "system", "content": [{"type": "text", "text": "sys"}]},
     {"role": "user", "content": [{"type": "image", "image": "i.png"}, {"image_url": "u"}, {"text": "t"}]},
     {"role": "assistant", "content": [{"type": "text", "text": "Best Option: ("}]}],
    [{"role": "user", "content": "plain text"}],
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
@pytest.mark.parametrize("gen", [True, False])
def test_chat_template_bit_equal(i, gen):
    got = proc.render_chat_template(MESSAGES[i], add_generation_prompt=gen)
    assert got == jproc.render_chat_template(MESSAGES[i], add_generation_prompt=gen)


def test_chat_template_shapes():
    got = proc.render_chat_template(MESSAGES[0])
    assert got == ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                   "<|im_start|>user\nFind the event.<|vision_start|><|video_pad|><|vision_end|><|im_end|>\n"
                   "<|im_start|>assistant\n")
    assert "helpful assistant" not in proc.render_chat_template(MESSAGES[1], add_generation_prompt=False)


PATCHIFY_CASES = [((5, 3, 56, 84), {}), ((4, 3, 28, 56), {}), ((8, 3, 364, 644), {}),
                  ((3, 3, 56, 56), dict(do_rescale=False)), ((2, 3, 84, 28), dict(do_normalize=False)),
                  ((7, 1, 56, 56), dict(do_normalize=False))]


@pytest.mark.parametrize("shape,kw", PATCHIFY_CASES)
def test_native_patchify_bit_equal_to_jax_and_plain(shape, kw):
    frames = np.random.default_rng(0).uniform(0, 255, size=shape).astype(np.float32)
    got, grid = proc.patchify_video_native(frames, **kw)
    want, want_grid = jproc.patchify_video(frames, **kw)
    plain, plain_grid = proc.patchify_video(frames, **kw)
    assert grid == want_grid == plain_grid == ((shape[0] + 1) // 2, shape[2] // 14, shape[3] // 14)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_patchify_rejects_frames_off_the_grid():
    for fn in (proc.patchify_video, proc.patchify_video_native):
        with pytest.raises(ValueError, match="multiple of 28"):
            fn(np.zeros((2, 3, 42, 56), np.float32))


def test_patchify_matches_hf_image_processor():
    from transformers.image_utils import ChannelDimension
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import Qwen2VLImageProcessor

    T = 5
    frames = np.random.default_rng(0).uniform(0, 255, size=(T, 3, 56, 84)).astype(np.float32)
    mean, std = proc.OPENAI_CLIP_MEAN.tolist(), proc.OPENAI_CLIP_STD.tolist()
    hf = Qwen2VLImageProcessor(do_resize=False, do_rescale=True, do_normalize=True, image_mean=mean, image_std=std)
    hf_flat, hf_grid = hf._preprocess(
        [frames[i] for i in range(T)], do_resize=False, do_rescale=True, rescale_factor=1 / 255,
        do_normalize=True, image_mean=mean, image_std=std, patch_size=14, temporal_patch_size=2, merge_size=2,
        do_convert_rgb=False, input_data_format=ChannelDimension.FIRST,
    )
    flat, grid = proc.patchify_video_native(frames)
    assert grid == tuple(hf_grid)
    np.testing.assert_allclose(flat, hf_flat, atol=1e-5, rtol=1e-5)


def _processors(tok=None):
    tok = tok or TinyTokenizer()
    kw = dict(pad_token_id=0, eos_token_id=1)
    return proc.Qwen25VLProcessor(tok, **kw), jproc.Qwen25VLProcessor(tok, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    assert (got.pixel_values_videos is None) == (want.pixel_values_videos is None)
    if want.pixel_values_videos is not None:
        np.testing.assert_array_equal(got.pixel_values_videos, want.pixel_values_videos)
        np.testing.assert_array_equal(got.video_grid_thw, want.video_grid_thw)
    assert got.second_per_grid_ts == want.second_per_grid_ts


@pytest.mark.parametrize("padding_side", ["left", "right"])
def test_processor_call_matches_jax(padding_side):
    mine, ref = _processors()
    rng = np.random.default_rng(1)
    videos = [rng.uniform(0, 255, size=(4, 3, 28, 56)).astype(np.float32),
              rng.uniform(0, 255, size=(3, 3, 56, 56)).astype(np.float32)]
    texts = [mine.apply_chat_template(MESSAGES[0]), mine.apply_chat_template(MESSAGES[1]) + "<think>\n</think>\n"]
    assert texts == [ref.apply_chat_template(MESSAGES[0]), ref.apply_chat_template(MESSAGES[1]) + "<think>\n</think>\n"]
    got = mine(text=texts, videos=videos, fps=[2.0, 0.5], padding_side=padding_side)
    _assert_same(got, ref(text=texts, videos=videos, fps=[2.0, 0.5], padding_side=padding_side))
    assert [int((row == 253).sum()) for row in got.input_ids] == [2 * 2 * 4 // 4, 2 * 4 * 4 // 4]
    assert got.second_per_grid_ts == [1.0, 4.0]
    _assert_same(mine(text=["ab", "a"]), ref(text=["ab", "a"]))
    _assert_same(mine(text=texts[:1], videos=videos[:1]), ref(text=texts[:1], videos=videos[:1]))


class FakeTokenizer:
    """tests/test_processor.py's char-level stub with Qwen special tokens."""

    chat_template = None
    SPECIALS = ["<|video_pad|>", "<|vision_start|>", "<|vision_end|>", "<|im_start|>", "<|im_end|>"]

    def encode(self, s, add_special_tokens=False):
        out, i = [], 0
        while i < len(s):
            for j, sp in enumerate(self.SPECIALS):
                if s.startswith(sp, i):
                    out.append(1000 + j)
                    i += len(sp)
                    break
            else:
                out.append(ord(s[i]) % 1000)
                i += 1
        return out

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(i) if i < 1000 else "" for i in ids)


def test_processor_expansion_and_padding():
    mine = proc.Qwen25VLProcessor(FakeTokenizer(), pad_token_id=0)
    video = np.random.default_rng(1).uniform(0, 255, size=(4, 3, 28, 56)).astype(np.float32)
    text = proc.render_chat_template(
        [{"role": "user", "content": [{"type": "text", "text": "hi"}, {"type": "video", "video": "v"}]}])
    out = mine(text=[text], videos=[video], fps=[2.0])
    assert tuple(out.video_grid_thw[0]) == (2, 2, 4)
    assert out.pixel_values_videos.shape == (16, 1176)
    assert int((out.input_ids == 1000).sum()) == 4
    assert out.second_per_grid_ts == [1.0]
    out2 = mine(text=["ab", "a"], videos=None)
    assert out2.input_ids.shape == (2, 2)
    assert out2.attention_mask[1, 0] == 0 and out2.attention_mask[1, 1] == 1


def test_tokenizer_chat_template_wins_and_decode():
    class Templated(TinyTokenizer):
        chat_template = "custom"

        def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
            return f"T{len(messages)}{int(add_generation_prompt)}"

    mine, ref = _processors(Templated())
    assert mine.apply_chat_template(MESSAGES[1], False) == ref.apply_chat_template(MESSAGES[1], False) == "T20"
    ids = [[2, 40, 41, 1, 253, 99], [3, 4, 250]]
    for skip in (True, False):
        assert mine.batch_decode(ids, skip) == ref.batch_decode(ids, skip)
        assert mine.decode(ids[0], skip_special_tokens=skip) == ref.decode(ids[0], skip_special_tokens=skip)


def test_from_pretrained_loads_a_local_tokenizer(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(["[UNK]", "find", "the", "event", "<|video_pad|>"])}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]").save_pretrained(tmp_path)
    mine = proc.Qwen25VLProcessor.from_pretrained(str(tmp_path), pad_token_id=0)
    ref = jproc.Qwen25VLProcessor.from_pretrained(str(tmp_path), pad_token_id=0)
    _assert_same(mine(text=["find the event", "the"]), ref(text=["find the event", "the"]))
    assert mine.tokenizer.encode("find the event", add_special_tokens=False) == [1, 2, 3]
