"""The port's video I/O and drawing (utils/video.py) and native host runtime
(utils/native.py, built from csrc/host/posebyte_native.cpp) against the JAX
package's on the CPU, on the same seeded tracks and images:

- the native rasteriser's drawing of tracks, and its CPU letterbox, byte
  for byte equal to the JAX package's native library (the same source and
  flags, each built by its own package);
- the cv2 drawing (draw_pose, draw_all_tracks(use_native=False),
  draw_stats(use_native=False)) byte for byte equal to the JAX package's;
- the native draw_stats and chip_smoke.py's fixed drawing, whose digest the
  card's host must reproduce;
- a VideoWriter -> VideoReader / PrefetchVideoReader round trip.
"""
import importlib.util
import os

import numpy as np
import pytest

from posebyte_tpu.utils import native as j_native
from posebyte_tpu.utils import video as j_video

from posebyte_tpu_torch.tracker.output import TrackOutput
from posebyte_tpu_torch.utils import native, video
from posebyte_tpu_torch.utils.synthetic import (SyntheticScene, pose_bbox,
                                                render_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs():
    assert native.load() is not None, "the port's native library"
    assert j_native.load() is not None, "the JAX package's native library"


def _tracks(seed, n=8, w=640, h=360):
    """Seeded tracks: ids across the palette's wrap, boxes partly out of
    the frame, low-confidence keypoints."""
    rng = np.random.default_rng(seed)
    poses = SyntheticScene(n, w, h, seed=seed).step()
    poses[..., :2] += rng.normal(0, 2.0, poses[..., :2].shape) \
        .astype(np.float32)
    poses[..., 2] = rng.uniform(0.0, 1.0, poses[..., 2].shape)
    poses[0, :, 0] -= 60.0
    return [TrackOutput(track_id=int(rng.integers(0, 45)),
                        score=float(rng.uniform(0.3, 1.0)),
                        bbox=pose_bbox(p), keypoints=p) for p in poses]


def _frame(seed, w=640, h=360):
    return render_frame(SyntheticScene(3, w, h, seed=seed + 1).step(), w, h)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_draw_tracks_matches_jax(libs, seed):
    tracks = _tracks(seed)
    got = video.draw_all_tracks(_frame(seed), tracks)
    want = j_native.draw_tracks_native(_frame(seed), tracks,
                                       j_video.TRACK_COLORS)
    np.testing.assert_array_equal(got, want)
    assert (got != _frame(seed)).any()
    np.testing.assert_array_equal(video.TRACK_COLORS, j_video.TRACK_COLORS)
    assert native.draw_tracks_native(_frame(seed), [], video.TRACK_COLORS) \
        .tobytes() == _frame(seed).tobytes()


def test_native_draw_refuses_a_view(libs):
    """It draws in place: a non-contiguous view is refused (the JAX
    package's would draw into a copy and drop it)."""
    frame = np.zeros((360, 1280, 3), np.uint8)[:, ::2]
    with pytest.raises(ValueError, match="C-contiguous"):
        video.draw_all_tracks(frame, _tracks(0))


@pytest.mark.parametrize("shape,target", [((90, 160), 64),
                                          ((360, 640), 256),
                                          ((333, 517), 128)])
def test_native_letterbox_matches_jax(libs, shape, target):
    img = np.random.default_rng(target).integers(0, 255, shape + (3,),
                                                 dtype=np.uint8)
    for bgr in (True, False):
        got = native.letterbox_cpu(img, target, bgr)
        want = j_native.letterbox_cpu(img, target, bgr)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2])
def test_cv2_drawing_matches_jax(seed):
    tracks = _tracks(seed)
    np.testing.assert_array_equal(
        video.draw_all_tracks(_frame(seed), tracks, use_native=False),
        j_video.draw_all_tracks(_frame(seed), tracks, use_native=False))
    np.testing.assert_array_equal(
        video.draw_stats(_frame(seed), 31.25, 4, 17.5, use_native=False),
        j_video.draw_stats(_frame(seed), 31.25, 4, 17.5))
    a, b = _frame(seed), _frame(seed)
    video.draw_pose(a, tracks[1].keypoints, (10, 200, 30), kp_radius=4)
    j_video.draw_pose(b, tracks[1].keypoints, (10, 200, 30), kp_radius=4)
    np.testing.assert_array_equal(a, b)


def test_native_draw_stats(libs):
    """The overlay without cv2: each line in green over a black copy, in
    the top-left corner."""
    frame = np.zeros((120, 320, 3), np.uint8)
    video.draw_stats(frame, 29.97, 6, 12.34)
    green = (frame == (0, 255, 0)).all(-1)
    assert green.sum() > 300
    ys, xs = np.nonzero(frame.any(-1))
    assert ys.max() < 10 + 3 * 28 and xs.min() >= 10
    again = np.zeros_like(frame)
    video.draw_stats(again, 29.97, 6, 12.34)
    np.testing.assert_array_equal(frame, again)


def test_chip_smoke_draw_digest(libs):
    """chip_smoke.py's cli phase compares the card host's native drawing
    with the digest recorded here."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.draw_digest() == smoke.DRAW_DIGEST


def test_native_builds_into_its_build_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("POSEBYTE_NATIVE_BUILD_DIR", str(tmp_path / "b"))
    path = native.library_path()
    assert path.startswith(str(tmp_path / "b"))
    assert native.build() == path and os.path.exists(path)
    assert os.listdir(tmp_path / "b") == [os.path.basename(path)]


def test_video_round_trip(tmp_path):
    frames = [_frame(s, 320, 240) for s in range(8)]
    path = str(tmp_path / "clip.mp4")
    writer = video.VideoWriter(path, 320, 240, 25.0)
    for f in frames:
        writer.write(f)
    writer.release()
    reader = video.VideoReader(path)
    assert (reader.width, reader.height, reader.frame_count) == (320, 240, 8)
    assert reader.fps == 25.0
    got = list(reader)
    reader.release()
    assert len(got) == 8 and got[0].shape == (240, 320, 3)
    # lossy mp4v: close to what was written
    assert np.abs(got[3].astype(int) - frames[3]).mean() < 8
    pre = video.PrefetchVideoReader(path, depth=2)
    again = list(pre)
    pre.release()
    assert len(again) == 8
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    early = video.PrefetchVideoReader(path, depth=2)
    assert early.read() is not None
    early.release()                  # stops its worker without draining
    assert early.read() is None
    with pytest.raises(IOError):
        video.VideoReader(str(tmp_path / "missing.mp4"))
