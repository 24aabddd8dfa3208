"""The port's VideoRecorder (utils/video.py, its own GIF89a writer) against
the JAX package's (PIL), and two signature faults closed against the JAX
package (ROADMAP §3 items 2 and 4): `save_trajectory`'s third argument and
`native_loader.native_available`.

The GIF's palette is not PIL's, so the frames are compared decoded, not as
bytes: a frame of at most 256 colours exactly; a smooth frame of more
within PIL's own loss on the JAX file (mean |gap| at most 1.25x PIL's, the
largest at most 1.25x PIL's largest). The delay and loop fields, as PIL
reads them, equal the JAX file's; `save_frames_npz` writes the same arrays.
"""
import numpy as np
import pytest
from PIL import Image, ImageSequence

from real_robot_nerf_actor_tpu.data.demos import Trajectory as JaxTrajectory
from real_robot_nerf_actor_tpu.data.episodes import save_trajectory as jax_save
from real_robot_nerf_actor_tpu.utils.video import VideoRecorder as JaxRecorder
from real_robot_nerf_actor_tpu_torch.data import native_loader
from real_robot_nerf_actor_tpu_torch.data.demos import Trajectory
from real_robot_nerf_actor_tpu_torch.data.episodes import load_trajectory, save_trajectory
from real_robot_nerf_actor_tpu_torch.utils.video import VideoRecorder, lzw_encode


class _Env:
    """render() hands out the given frames in turn."""

    def __init__(self, frames):
        self.frames = list(frames)

    def render(self):
        return self.frames.pop(0)


def _smooth(n=4, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin((xx + yy + 4 * i) / 7.0)],
                     -1).astype(np.float32) for i in range(n)]


def _decoded(path):
    im = Image.open(path)
    return im.info, [np.asarray(f.convert("RGB")).astype(np.int64)
                     for f in ImageSequence.Iterator(im)]


def _record(cls, d, frames, fps=15):
    rec = cls(str(d), fps=fps)
    rec.init(_Env(frames[:1]))
    for f in frames[1:]:
        rec.record_frame(f)
    return rec


def test_gif_frames_delay_and_loop_match_jax(tmp_path):
    frames = _smooth()
    want8 = [(np.clip(f, 0, 1) * 255).astype(np.uint8).astype(np.int64) for f in frames]
    jinfo, jframes = _decoded(_record(JaxRecorder, tmp_path / "jax", frames).save("ep"))
    info, got = _decoded(_record(VideoRecorder, tmp_path / "port", frames).save("ep"))
    assert (info["duration"], info["loop"]) == (jinfo["duration"], jinfo["loop"]) == (60, 0)
    assert len(got) == len(jframes) == len(frames)
    for g, j, w in zip(got, jframes, want8):
        pil_mean, pil_max = np.abs(j - w).mean(), np.abs(j - w).max()
        assert np.abs(g - w).mean() <= 1.25 * pil_mean, (np.abs(g - w).mean(), pil_mean)
        assert np.abs(g - w).max() <= 1.25 * pil_max


@pytest.mark.parametrize("fps", [10, 30])
def test_gif_of_few_colours_is_exact(tmp_path, fps):
    """Frames of at most 256 colours (uint8, any size, an odd count of
    pixels and long runs) decode exactly; the delay is stored as PIL stores
    it."""
    rng = np.random.default_rng(fps)
    lut = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    frames = [lut[rng.integers(0, 200, (37, 53))], np.zeros((37, 53, 3), np.uint8),
              lut[np.repeat(np.arange(53)[None] % 7, 37, 0)]]
    jinfo, _ = _decoded(_record(JaxRecorder, tmp_path / "jax", frames, fps).save("ep.gif"))
    info, got = _decoded(_record(VideoRecorder, tmp_path / "port", frames, fps).save("ep.gif"))
    assert info["duration"] == jinfo["duration"] and info["loop"] == jinfo["loop"]
    for g, w in zip(got, frames):
        np.testing.assert_array_equal(g, w)


def test_lzw_round_trip_across_code_widths():
    """The LZW stream of 70,000 random indices (past the 4096-code table,
    so clears and every width from 9 to 12 bits) decodes back, by a plain
    decoder written from the GIF spec."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 256, 70000).astype(np.uint8)
    data = lzw_encode(idx)
    bits = int.from_bytes(data, "little")
    pos, width, table, out, prev = 0, 9, None, [], None
    while True:
        code = (bits >> pos) & ((1 << width) - 1)
        pos += width
        if code == 256:
            table, width, prev = {i: bytes([i]) for i in range(256)}, 9, None
            continue
        if code == 257:
            break
        entry = table[code] if code in table else table[prev] + table[prev][:1]
        out.append(entry)
        if prev is not None and len(table) + 2 < 4096:
            table[len(table) + 2] = table[prev] + entry[:1]
        if len(table) + 2 >= (1 << width) and width < 12:
            width += 1
        prev = code
    assert b"".join(out) == idx.tobytes()


def test_frames_npz_and_disabled_recorder_match_jax(tmp_path):
    frames = _smooth(3)
    j = _record(JaxRecorder, tmp_path / "jax", frames).save_frames_npz("ep")
    t = _record(VideoRecorder, tmp_path / "port", frames).save_frames_npz("ep")
    np.testing.assert_array_equal(np.load(t)["frames"], np.load(j)["frames"])
    off = VideoRecorder(None)
    off.record(_Env(frames))
    assert not off.enabled and off.save("x") is None and off.save_frames_npz("x") is None


# ---------------------------------------------------------------- faults
def _trajectory(cls, pointcloud):
    rng = np.random.default_rng(0)
    obs = ([{"points": rng.standard_normal((50, 3)), "colors": rng.random((50, 3))}
            for _ in range(3)] if pointcloud else [rng.random((8, 8, 3)) for _ in range(3)])
    return cls(observations=obs, actions=[rng.standard_normal(4) for _ in range(3)],
               rewards=[0.0, 0.5, 1.0], ee_positions=[rng.standard_normal(3) for _ in range(3)],
               gripper_open=[1.0, 1.0, 0.0], success=True)


@pytest.mark.parametrize("pointcloud", [False, True])
def test_save_trajectory_takes_and_ignores_pointclouds(tmp_path, pointcloud):
    """ROADMAP §3 item 2: the JAX signature's third argument is accepted and
    ignored: the file holds what a call without it writes, and what the JAX
    package writes."""
    tr = _trajectory(Trajectory, pointcloud)
    save_trajectory(str(tmp_path / "a.npz"), tr)
    save_trajectory(str(tmp_path / "b.npz"), tr, [np.zeros((9, 3))])
    save_trajectory(str(tmp_path / "c.npz"), tr, pointclouds=None)
    jax_save(str(tmp_path / "j.npz"), _trajectory(JaxTrajectory, pointcloud), [np.zeros((9, 3))])
    a = np.load(tmp_path / "a.npz")
    for name in ("b", "c", "j"):
        other = np.load(tmp_path / f"{name}.npz")
        assert set(other.files) == set(a.files)
        for k in a.files:
            np.testing.assert_array_equal(other[k], a[k], err_msg=f"{name} {k}")
    assert load_trajectory(str(tmp_path / "b.npz")).success


def test_native_available(monkeypatch, tmp_path):
    """ROADMAP §3 item 4: True where g++ builds the loader; False, without
    raising, when there is no g++ (and nothing built); the loader itself
    still raises."""
    import shutil
    assert shutil.which("g++") is not None
    assert native_loader.native_available()
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    assert native_loader.native_available() is False
    with pytest.raises(RuntimeError, match="g.. not found"):
        native_loader.read_ply_native(str(tmp_path / "x.ply"))
