"""The port's video decoder and pipeline (`time_r1_tpu_torch/video/`) against
the JAX package's, on a clip that the test writes itself with OpenCV (mp4v,
24 frames at 8 fps, 96×160): frame count, fps and every decoded batch
(repeated, backward and past-the-end indices, tolerant mode) bit-equal;
`fetch_video` frames and sample fps bit-equal over budgets and windows; the
tolerant retry; and the native builds: atomic across processes, and a failed
build raises (nothing falls back to numpy).

Also the shared set-up of the port's input-path tests: `write_clip` and
`jax_native_libs`, which builds the JAX package's native libraries under an
fcntl lock (they build next to their sources without an atomic rename, and
parallel test workers would otherwise build them at the same moment)."""

import contextlib
import fcntl
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from time_r1_tpu.video import decoder as jdec
from time_r1_tpu.video import pipeline as jpipe
from time_r1_tpu.video import resize as jresize
from time_r1_tpu_torch.video import build, decoder, pipeline, resize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_FRAMES, CLIP_FPS, CLIP_H, CLIP_W = 24, 8.0, 96, 160


def write_clip(path, frames=CLIP_FRAMES, fps=CLIP_FPS, h=CLIP_H, w=CLIP_W, seed=0):
    """An mp4v clip of moving seeded content: smooth gradients that shift
    every frame, plus a noise block, so frames differ and resizes round."""
    import cv2

    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, size=(h // 4, w // 4, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for t in range(frames):
        img = np.stack([(xx * 3 + t * 11) % 256, (yy * 5 + t * 7) % 256, ((xx + yy) * 2 + t * 13) % 256],
                       axis=-1).astype(np.uint8)
        img[h // 4: h // 2, w // 4: w // 2] = np.roll(noise, t, axis=1)
        writer.write(img)
    writer.release()
    return str(path)


@contextlib.contextmanager
def _jax_build_lock():
    with open(os.path.join(tempfile.gettempdir(), "timer1_jax_native_build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def jax_native_libs():
    """Build (if stale) and load the JAX package's decoder and resize
    libraries, one process at a time. The JAX package's own tests build them
    without this lock; a library caught half-written by one of them fails to
    load, and is loaded again once that build (about a second) is done."""
    with _jax_build_lock():
        for attempt in range(3):
            try:
                jdec._lib()
                jresize._native_lib()
                return
            except OSError:
                if attempt == 2:
                    raise
                time.sleep(3)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    jax_native_libs()
    return write_clip(tmp_path_factory.mktemp("video") / "clip.mp4")


def _both(path):
    return decoder.VideoReader(path), jdec.VideoReader(path)


def test_reader_matches_jax(clip):
    mine, ref = _both(clip)
    try:
        assert len(mine) == len(ref) == CLIP_FRAMES
        assert mine.get_avg_fps() == ref.get_avg_fps() == CLIP_FPS
        assert (mine.height, mine.width) == (ref.height, ref.width) == (CLIP_H, CLIP_W)
        for indices in ([0, 5, 5, 10], [3], [1, 0], [23, 30, 40], [7, 2, 2, 19, 0], list(range(24))):
            got, want = mine.get_batch(indices), ref.get_batch(indices)
            assert got.shape == (len(indices), CLIP_H, CLIP_W, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=str(indices))
        batch = mine.get_batch([0, 5, 5, 10])
        np.testing.assert_array_equal(batch[1], batch[2])
        assert not np.array_equal(batch[0], batch[3])  # the clip moves
    finally:
        mine.close()
        ref.close()


def test_tolerant_decode_matches_jax_and_strict(clip):
    indices = [0, 5, 10, 10, 3, 23]
    mine, ref = _both(clip)
    try:
        got = mine.get_batch(indices, tolerant=True)
        np.testing.assert_array_equal(got, ref.get_batch(indices, tolerant=True))
    finally:
        mine.close()
        ref.close()
    strict = decoder.VideoReader(clip)
    try:
        np.testing.assert_array_equal(got, strict.get_batch(indices))
    finally:
        strict.close()


def test_reader_raises_on_a_missing_file_and_after_close(tmp_path, clip):
    with pytest.raises(IOError):
        decoder.VideoReader(str(tmp_path / "missing.mp4"))
    vr = decoder.VideoReader("file://" + clip)
    vr.close()
    vr.close()
    with pytest.raises(IOError, match="closed"):
        vr.get_batch([0])


ELES = [
    {"total_pixels": 3584 * 28 * 28, "min_pixels": 16 * 28 * 28},
    {"total_pixels": 8 * 28 * 28, "min_pixels": 4 * 28 * 28},
    {"nframes": 4},
    {"video_start": 0.5, "video_end": 2.0, "nframes": 6},
    {"video_start": 1.0, "total_pixels": 64 * 28 * 28, "min_pixels": 4 * 28 * 28},
    {"fps": 4.0, "max_pixels": 20 * 28 * 28},
    {"nframes": 4, "resized_height": 60, "resized_width": 100},
]


@pytest.mark.parametrize("i", range(len(ELES)))
def test_fetch_video_matches_jax(clip, i):
    ele = {"video": clip, **ELES[i]}
    got, got_fps = pipeline.fetch_video(dict(ele))
    want, want_fps = jpipe.fetch_video(dict(ele))
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 3
    assert got.shape[2] % 28 == 0 and got.shape[3] % 28 == 0
    np.testing.assert_array_equal(got, want)
    assert got_fps == want_fps
    assert pipeline.video_loader(dict(ele))[1] == got_fps


def test_fetch_video_falls_back_to_tolerant_decode(clip, monkeypatch):
    calls = []
    orig = decoder.VideoReader.get_batch

    def flaky(self, indices, tolerant=False):
        calls.append(tolerant)
        if not tolerant:
            raise IOError("decode failed (code -5)")
        return orig(self, indices, tolerant=False)

    monkeypatch.setattr(decoder.VideoReader, "get_batch", flaky)
    ele = {"video": clip, "total_pixels": 8 * 28 * 28, "min_pixels": 4 * 28 * 28, "video_end": 2.0}
    frames, fps = pipeline.fetch_video(dict(ele))
    assert calls == [False, True]
    monkeypatch.undo()
    want, want_fps = jpipe.fetch_video(dict(ele))
    np.testing.assert_array_equal(frames, want)
    assert fps == want_fps


BUILD_AND_CHECK = """
import sys
from pathlib import Path
import numpy as np
from time_r1_tpu_torch.video import build
from time_r1_tpu_torch.models.processor import patchify_video, patchify_video_native
build.BUILD = Path(sys.argv[1])
frames = np.random.default_rng(0).uniform(0, 255, (3, 3, 28, 56)).astype(np.float32)
assert np.array_equal(patchify_video_native(frames)[0], patchify_video(frames)[0])
"""


def test_native_builds_are_atomic_across_processes(tmp_path):
    """Four processes build the same library into an empty directory at
    once: each loads a whole library, one is left, and no temporary file."""
    out = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_CHECK, str(out)], cwd=REPO, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert sorted(os.listdir(out)) == ["libtimer1_resize.lock", "libtimer1_resize.so"]


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "NATIVE", src)
    monkeypatch.setattr(build, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        build.load("broken", "broken.cpp", ["-O2"])
    assert os.listdir(tmp_path / "_build") == ["libbroken.lock"]

    def no_compiler(*args, **kwargs):
        raise RuntimeError("building resize.cpp failed: g++ not found")

    # the resize and the processor's patchify raise too: no numpy fallback
    monkeypatch.setattr(resize, "_RESIZE_LIB", None)
    monkeypatch.setattr(build, "load", no_compiler)
    frames = np.zeros((2, 56, 84, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        resize.resize_frames_host(frames, 28, 56)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pipeline.resize_frames_bicubic(frames, 28, 56)
    from time_r1_tpu_torch.models.processor import patchify_video_native

    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        patchify_video_native(np.zeros((2, 3, 28, 28), np.float32))
