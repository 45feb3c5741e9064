"""The port's frame resize (`time_r1_tpu_torch/video/resize.py`) against the
JAX package's:

- the dense weights and the banded taps equal to JAX's;
- the native host resize bit-equal to JAX's native resize and to the port's
  numpy plain version (the same sources and flags; the same f32 sums in the
  same order);
- `resize_frames_device` (two f32 matmuls in torch, here on the CPU) within
  1 gray level, on under 1e-3 of the pixels, of torch's
  `F.interpolate(mode="bicubic", antialias=True)` and of JAX's device resize
  at 360×640 → 196×364 (JAX's own bound, `tests/test_resize.py`), with TF32
  off inside it whatever the caller set;
- `resize_frames_bicubic`'s backends (native by default, PIL on request)
  equal to JAX's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_video import jax_native_libs
from time_r1_tpu.video import pipeline as jpipe
from time_r1_tpu.video import resize as jresize
from time_r1_tpu_torch.video import pipeline, resize

torch.set_num_threads(2)

PAIRS = [(360, 196), (640, 364), (640, 392), (360, 252), (100, 224), (57, 228), (96, 56), (160, 84), (28, 28)]


@pytest.fixture(scope="module", autouse=True)
def jax_libs():
    jax_native_libs()


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("pair", PAIRS)
def test_weights_and_taps_match_jax(pair):
    w = resize.resize_weights(*pair)
    np.testing.assert_array_equal(w, jresize.resize_weights(*pair))
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-6)
    for got, want in zip(resize.resize_taps(*pair), jresize.resize_taps(*pair)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert not w.flags.writeable  # the cache hands one array to every caller


@pytest.mark.parametrize("shape,out", [((3, 360, 640, 3), (196, 364)), ((2, 96, 160, 3), (56, 84)),
                                       ((2, 56, 84, 3), (112, 168)), ((2, 61, 47, 1), (28, 56)),
                                       ((1, 360, 640, 3), (364, 644))])
def test_native_resize_bit_equal_to_jax_and_plain(shape, out):
    frames = _frames(1, shape)
    got = resize.resize_frames_host(frames, *out)
    assert got.shape == (shape[0], *out, shape[3]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jresize.resize_frames_host(frames, *out))
    np.testing.assert_array_equal(got, resize.resize_frames_plain(frames, *out))


def _torch_reference(frames, out_h, out_w):
    """torch's bicubic antialias=True (what torchvision's Resize calls), f32,
    one final round-half-even and clip: the upstream resize's semantics."""
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(out_h, out_w), mode="bicubic", antialias=True)
    return torch.clamp(x.round(), 0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def _within_one_gray(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def test_device_resize_holds_jax_bound():
    frames = _frames(3, (4, 360, 640, 3))
    got = resize.resize_frames_device(frames, 196, 364, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8 and got.shape == (4, 196, 364, 3)
    got = got.numpy()
    _within_one_gray(got, _torch_reference(frames, 196, 364))
    _within_one_gray(got, jresize.resize_frames_device(frames, 196, 364))
    _within_one_gray(got, resize.resize_frames_host(frames, 196, 364))


def test_device_resize_pins_full_f32(monkeypatch):
    """The caller asks for TF32; both matmuls run with it off, and the
    caller's setting is back afterwards."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args, **kwargs)

    frames = _frames(4, (2, 96, 160, 3))
    want = resize.resize_frames_device(frames, 56, 84, device="cpu")
    prev = torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch, "matmul", spy)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = resize.resize_frames_device(torch.from_numpy(frames), 56, 84, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False]
    assert torch.equal(got, want)


def test_resize_rejects_other_dtypes():
    frames = np.zeros((1, 56, 84, 3), np.float32)
    for fn in (resize.resize_frames_host, resize.resize_frames_plain):
        with pytest.raises(ValueError, match="uint8"):
            fn(frames, 28, 56)
    with pytest.raises(ValueError, match="uint8"):
        resize.resize_frames_device(frames, 28, 56, device="cpu")


def test_resize_frames_bicubic_backends_match_jax(monkeypatch):
    frames = _frames(5, (2, 96, 160, 3))
    monkeypatch.delenv("TIMER1_DEVICE_RESIZE", raising=False)
    monkeypatch.delenv("TIMER1_RESIZE_BACKEND", raising=False)
    np.testing.assert_array_equal(pipeline.resize_frames_bicubic(frames, 56, 84),
                                  jpipe.resize_frames_bicubic(frames, 56, 84))
    assert pipeline.resize_frames_bicubic(frames, 96, 160) is frames
    monkeypatch.setenv("TIMER1_RESIZE_BACKEND", "pil")
    np.testing.assert_array_equal(pipeline.resize_frames_bicubic(frames, 56, 84),
                                  jpipe.resize_frames_bicubic(frames, 56, 84))


def test_device_resize_backend_runs_on_the_card_or_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("TIMER1_DEVICE_RESIZE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.resize_frames_bicubic(_frames(6, (1, 96, 160, 3)), 56, 84)
