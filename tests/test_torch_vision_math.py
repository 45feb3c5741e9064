"""The port's video budgeting math (`utils/vision_math.py`) against the JAX
package's: every planner function over a grid of frame sizes, budgets,
frame counts, fps and timestamp windows, equal (integers and frame indices
exactly; sample_fps to the last bit, the same float operations), and the
same ValueErrors."""

import itertools
import math

import pytest

from time_r1_tpu.utils import vision_math as jvm
from time_r1_tpu_torch.utils import vision_math as vm

SIZES = [(480, 640), (720, 1280), (1080, 1920), (360, 640), (100, 100), (28, 28), (3, 5), (239, 421),
         (96, 160), (2160, 3840)]
BUDGETS = [(vm.MIN_PIXELS, vm.MAX_PIXELS), (vm.VIDEO_MIN_PIXELS, vm.VIDEO_MAX_PIXELS),
           (16 * 28 * 28, 3584 * 28 * 28), (128 * 28 * 28, int(150000.5)), (4 * 28 * 28, 8 * 28 * 28)]


def test_constants_match():
    names = ["IMAGE_FACTOR", "MIN_PIXELS", "MAX_PIXELS", "MAX_RATIO", "VIDEO_MIN_PIXELS", "VIDEO_MAX_PIXELS",
             "FRAME_FACTOR", "FPS", "FPS_MIN_FRAMES", "FPS_MAX_FRAMES", "VIDEO_TOTAL_PIXELS"]
    for n in names:
        assert getattr(vm, n) == getattr(jvm, n), n


@pytest.mark.parametrize("factor", [28, 2])
def test_factor_helpers_match(factor):
    for number in [0, 1, 3.5, 5, 14, 27, 28, 41, 42, 43, 55, 56, 700, 1e3 + 0.5]:
        for fn in ("round_by_factor", "ceil_by_factor", "floor_by_factor"):
            assert getattr(vm, fn)(number, factor) == getattr(jvm, fn)(number, factor), (fn, number)


@pytest.mark.parametrize("h,w", SIZES)
def test_smart_resize_matches(h, w):
    for min_p, max_p in BUDGETS:
        assert vm.smart_resize(h, w, 28, min_p, max_p) == jvm.smart_resize(h, w, 28, min_p, max_p)


def test_smart_resize_rejects_extreme_ratio():
    for h, w in [(1, 300), (300, 1)]:
        with pytest.raises(ValueError):
            vm.smart_resize(h, w)
        with pytest.raises(ValueError):
            jvm.smart_resize(h, w)


NFRAME_CASES = [
    ({}, 100, 30.0), ({}, 100, 29.97), ({}, 7, 30.0), ({}, 5000, 30.0), ({}, 5000, 23.976),
    ({"fps": 1.0}, 847, 29.97), ({"nframes": 17}, 100, 30.0), ({"fps": 2.0, "max_frames": 32}, 1000, 25.0),
    ({"fps": 2.0, "min_frames": 8}, 100, 30.0), ({}, 4, 30.0), ({}, 2, 30.0), ({}, 320, 10.0), ({}, 24, 8.0),
]


@pytest.mark.parametrize("ele,total,fps", NFRAME_CASES)
def test_smart_nframes_matches(ele, total, fps):
    assert vm.smart_nframes(dict(ele), total, fps) == jvm.smart_nframes(dict(ele), total, fps)


@pytest.mark.parametrize("ele,total,fps", [({}, 1, 30.0), ({"nframes": 40}, 30, 30.0), ({"nframes": 1}, 30, 30.0)])
def test_smart_nframes_raises_alike(ele, total, fps):
    with pytest.raises(ValueError):
        vm.smart_nframes(dict(ele), total, fps)
    with pytest.raises(ValueError):
        jvm.smart_nframes(dict(ele), total, fps)


def test_per_frame_max_pixels_matches():
    for n, total, min_p in itertools.product([2, 4, 8, 64, 70, 512, 768], [None, 3584 * 28 * 28, 8 * 28 * 28],
                                            [16 * 28 * 28, vm.VIDEO_MIN_PIXELS]):
        assert vm.per_frame_max_pixels(n, total, min_p) == jvm.per_frame_max_pixels(n, total, min_p)


WINDOWS = [dict(), dict(video_start=1.0, video_end=7.5), dict(video_start=0.0, video_end=35.04),
           dict(video_start=34.9, video_end=35.0), dict(video_start=None, video_end=None),
           dict(video_start=2.0), dict(video_end=3.0), dict(nframes=4), dict(fps=1.0, video_start=0.5)]


@pytest.mark.parametrize("total,fps", [(1051, 30.0), (240, 24.0), (300, 29.97), (24, 8.0), (320, 10.0),
                                       (120, 30.0)])
def test_plan_frame_window_matches(total, fps):
    for ele in WINDOWS:
        try:
            want = jvm.plan_frame_window(dict(ele), total, fps)
        except ValueError:
            with pytest.raises(ValueError):
                vm.plan_frame_window(dict(ele), total, fps)
            continue
        got = vm.plan_frame_window(dict(ele), total, fps)
        assert (got.start_frame, got.end_frame, got.nframes, got.indices) == \
            (want.start_frame, want.end_frame, want.nframes, want.indices), ele
        assert got.sample_fps == want.sample_fps and math.isfinite(got.sample_fps)


def test_plan_frame_window_degenerate_windows_raise_alike():
    for ele in [dict(video_start=5.0, video_end=5.0), dict(video_start=40.0, video_end=50.0)]:
        with pytest.raises(ValueError):
            vm.plan_frame_window(dict(ele), 1051, 30.0)
        with pytest.raises(ValueError):
            jvm.plan_frame_window(dict(ele), 1051, 30.0)


@pytest.mark.parametrize("h,w", SIZES[:-1])
def test_plan_video_shapes_matches(h, w):
    for nframes, total, min_p, max_p in itertools.product([2, 8, 64, 70], [None, 3584 * 28 * 28, 8 * 28 * 28],
                                                          [16 * 28 * 28, vm.VIDEO_MIN_PIXELS, 4 * 28 * 28],
                                                          [None, 100 * 28 * 28]):
        got = vm.plan_video_shapes(h, w, nframes, total, min_p, max_p)
        assert got == jvm.plan_video_shapes(h, w, nframes, total, min_p, max_p)
        assert got[0] % 28 == 0 and got[1] % 28 == 0


def test_chip_phase_clips_plan_as_stated():
    """The two clips of chip_smoke.py's phase 8 at TrainConfig's budget: 32 s
    at 10 fps → 64 frames at 196×392 (3136 video tokens), 4 s at 30 fps → 8
    frames at 364×644 (1196)."""
    total, min_p = 3584 * 28 * 28, 16 * 28 * 28
    for (n, fps), want in [((320, 10.0), (64, (196, 392), 3136)), ((120, 30.0), (8, (364, 644), 1196))]:
        plan = vm.plan_frame_window({"total_pixels": total, "min_pixels": min_p}, n, fps)
        shape = vm.plan_video_shapes(360, 640, plan.nframes, total, min_p)
        tokens = (plan.nframes // 2) * (shape[0] // 14) * (shape[1] // 14) // 4
        assert (plan.nframes, shape, tokens) == want
