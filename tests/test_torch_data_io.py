"""The port's readers and writers of recorded demos against the JAX
package's: PLY, the xArm keyframe dumps, calibration, `load_rgb_pcd` and
`ReplaySource` on tests/fixtures/demo_kitchen (all exact: both packages run
the same numpy arithmetic), the PNG codec against PIL (pixel-exact, on PNGs
that PIL writes with its own filters, on PNGs built here with each of the
five scanline filters, and on PNGs the port writes), and the native PLY
loader built from the port's own C++ copy against the port's `read_ply`."""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from real_robot_nerf_actor_tpu.data import calibration as jcal
from real_robot_nerf_actor_tpu.data.keyframes import extract_keyframes as j_extract
from real_robot_nerf_actor_tpu.data.keyframes import parse_xarm_position_file as j_parse
from real_robot_nerf_actor_tpu.data.ply import read_ply as j_read_ply
from real_robot_nerf_actor_tpu.data.ply import write_ply as j_write_ply
from real_robot_nerf_actor_tpu.data.replay import ReplaySource as JaxSource
from real_robot_nerf_actor_tpu.data.replay import load_rgb_pcd as j_load
from real_robot_nerf_actor_tpu_torch.data import calibration as tcal
from real_robot_nerf_actor_tpu_torch.data import native_loader
from real_robot_nerf_actor_tpu_torch.data.keyframes import (
    extract_keyframes, parse_xarm_position_file)
from real_robot_nerf_actor_tpu_torch.data.ply import read_ply, write_ply
from real_robot_nerf_actor_tpu_torch.data.png import read_png, read_png_rgb, write_png
from real_robot_nerf_actor_tpu_torch.data.replay import (
    ReplaySource, load_rgb_pcd, pad_point_cloud)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "demo_kitchen")


def _cloud(n=3000, seed=0, far=0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 1, (n - far, 3)),
                          rng.uniform(3.5, 4.5, (far, 3))]).astype(np.float32)
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors", [True, False])
def test_ply_round_trip_matches_jax(tmp_path, binary, colors):
    """Each package reads the other's files, and both write the same bytes."""
    pts, cols = _cloud()
    cols = cols if colors else None
    write_ply(str(tmp_path / "t.ply"), pts, cols, binary=binary)
    j_write_ply(str(tmp_path / "j.ply"), pts, cols, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for path in ("t.ply", "j.ply"):
        got, want = read_ply(str(tmp_path / path)), j_read_ply(str(tmp_path / path))
        np.testing.assert_array_equal(got[0], want[0])
        if colors:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


def test_keyframes_match_jax():
    for d in range(2):
        path = os.path.join(FIXTURE, f"{d}_xarm_position.txt")
        if not os.path.exists(path):
            continue
        got, want = parse_xarm_position_file(path), j_parse(path)
        for k in ("xyz", "rotation", "gripper_open"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
            assert getattr(got, k).dtype == getattr(want, k).dtype
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 30))
        grip = rng.integers(0, 2, n).astype(float)
        roll = np.cumsum(rng.normal(0, 2.0, n))
        assert extract_keyframes(grip, roll) == j_extract(grip, roll)


def test_calibration_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for _ in range(5):
        r, p, y = rng.uniform(-np.pi, np.pi, 3)
        np.testing.assert_array_equal(tcal.euler_to_matrix(r, p, y),
                                      jcal.euler_to_matrix(r, p, y))
        desk = np.eye(4)
        desk[:3, :3] = jcal.euler_to_matrix(r, p, y)
        desk[:3, 3] = rng.normal(0, 1, 3)
        ori, pos = np.eye(4), np.eye(4)
        pos[:3, 3] = rng.normal(0, 0.1, 3)
        for gl in (True, False):
            np.testing.assert_array_equal(
                tcal.compose_cam2base(desk, ori, pos, gl),
                jcal.compose_cam2base(desk, ori, pos, gl))
    tcal.save_calibration(str(tmp_path / "t.json"), desk, focal=76.18)
    jcal.save_calibration(str(tmp_path / "j.json"), desk, focal=76.18)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    np.testing.assert_array_equal(tcal.load_calibration(str(tmp_path / "t.json")), desk)
    pts, cols = _cloud(seed=2)
    bounds = np.array([-1, -1, -1, 1, 1, 1.0])
    got, want = tcal.get_heightmap(pts, cols, bounds, 0.05), \
        jcal.get_heightmap(pts, cols, bounds, 0.05)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_load_rgb_pcd_and_source_match_jax_on_the_fixture():
    src, jsrc = ReplaySource(FIXTURE, 1), JaxSource(FIXTURE, 1)
    np.testing.assert_array_equal(src.cam2base, jsrc.cam2base)
    assert src.num_keyframes(0) == jsrc.num_keyframes(0) == 4
    assert src.has_views == jsrc.has_views and src.has_holdout == jsrc.has_holdout
    for k in range(src.num_keyframes(0)):
        for a, b in zip(src.pose(0, k), jsrc.pose(0, k)):
            np.testing.assert_array_equal(a, b)
        got, want = src.pointcloud(0, k), jsrc.pointcloud(0, k)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.colors, want.colors)
    cam2base = np.eye(4)
    cam2base[:3, :3] = jcal.euler_to_matrix(0.3, -0.2, 1.1)
    cam2base[:3, 3] = [0.1, -0.4, 0.9]
    path = os.path.join(FIXTURE, "real0", "pcd1.ply")
    got, want = load_rgb_pcd(path, cam2base, 1.2), j_load(path, cam2base, 1.2)
    assert 0 < len(got.points) < len(read_ply(path)[0])   # the range filter cut some
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)


# ------------------------------------------------------------------ PNG
def _filtered_png(path, img, ftype):
    """An RGB(A) PNG whose every scanline uses filter `ftype` (0-4), encoded
    here from the PNG specification."""
    h, w, c = img.shape
    rows, prior = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"tEXt", b"Comment\x00skipped")
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def _image(h, w, c, seed=0):
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 7 + y * 3), (x * x + 2 * y), (y * y + 5 * x), 255 - x * y],
                    -1)[..., :c]
    noise = np.random.default_rng(seed).integers(0, 40, (h, w, c))
    return ((base + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_reads_every_filter_as_pil(tmp_path, ftype, channels):
    """A smooth image and one of uniform random bytes (which meets every
    tie of the Paeth predictor)."""
    noise = np.random.default_rng(ftype).integers(0, 256, (40, 40, channels)).astype(np.uint8)
    for i, img in enumerate((_image(13, 17, channels, seed=ftype), noise)):
        path = str(tmp_path / f"f{i}.png")
        _filtered_png(path, img, ftype)
        want = np.asarray(Image.open(path))
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(read_png(path), want)
        np.testing.assert_array_equal(read_png_rgb(path),
                                      np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode,shape", [("RGB", (24, 32, 3)), ("RGBA", (9, 7, 4)),
                                        ("L", (11, 5, 1)), ("LA", (6, 10, 2))])
def test_png_reads_what_pil_writes_and_pil_reads_ours(tmp_path, mode, shape):
    """PIL picks its own scanline filters; convert("RGB") repeats gray and
    drops alpha. What the port writes (filter None), PIL reads the same."""
    img = _image(*shape)
    arr = img[..., 0] if shape[-1] == 1 else img
    path = str(tmp_path / "pil.png")
    Image.fromarray(arr, mode).save(path)
    np.testing.assert_array_equal(read_png(path).reshape(arr.shape), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(read_png_rgb(path), np.asarray(Image.open(path).convert("RGB")))
    if mode != "LA":
        ours = str(tmp_path / "ours.png")
        write_png(ours, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(ours)), arr)
        np.testing.assert_array_equal(read_png(ours).reshape(arr.shape), arr)


def test_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(4, 4, 3)).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        read_png(path)
    Image.fromarray(_image(4, 4, 3)).save(path)
    data = bytearray(open(path, "rb").read())
    data[30] ^= 0xFF                     # inside IHDR: its CRC no longer holds
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(path)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, np.zeros((2, 2, 3), np.float32))


# ----------------------------------------------------------- native loader
@pytest.mark.parametrize("binary", [True, False])
def test_native_reader_matches_read_ply(tmp_path, binary):
    """Binary: equal; ascii: the points as the text prints them (the C++
    parser's strtof and numpy's loadtxt agree to 1e-6), colours exact."""
    pts, cols = _cloud(n=4000, seed=3)
    path = str(tmp_path / "c.ply")
    write_ply(path, pts, cols, binary=binary)
    got, want = native_loader.read_ply_native(path), read_ply(path)
    if binary:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    assert str(native_loader.build()).startswith(str(native_loader.BUILD_DIR))


def test_native_prefetcher_matches_the_replay_loader(tmp_path):
    """FIFO order, the range filter, cam2base and the rgb map of
    load_rgb_pcd + pad_point_cloud (points to 1e-6: the native side
    transforms in float64, numpy in float32)."""
    cam2base = np.eye(4)
    cam2base[:3, :3] = jcal.euler_to_matrix(0.2, 0.1, -0.4)
    cam2base[:3, 3] = [0.5, -0.2, 0.3]
    paths = []
    for s in range(4):
        pts, cols = _cloud(n=1000 + 100 * s, seed=s, far=50)
        paths.append(str(tmp_path / f"p{s}.ply"))
        write_ply(paths[-1], pts, cols)
    with native_loader.NativePrefetcher(max_num_coords=1600, n_workers=3, capacity=2) as pf:
        for p in paths:
            pf.submit(p, cam2base)
        for p in paths:
            xyz, rgb, valid = pf.next()
            want = pad_point_cloud(load_rgb_pcd(p, cam2base), 1600)
            n = int(want[2].sum())
            assert valid.sum() == n
            np.testing.assert_allclose(xyz[valid], want[0][:n], rtol=0, atol=1e-6)
            np.testing.assert_allclose(rgb[valid], want[1][:n], rtol=0, atol=1e-6)


def test_native_prefetcher_emits_when_later_jobs_finish_first(tmp_path):
    """A result that is next in FIFO order must get into a full queue: with
    capacity 1 and two workers, job 1 (a few points) finishes while job 0
    (200000 points) is still parsed and takes the only slot, and job 0's
    worker must not then wait for room that only loader_next, waiting for
    job 0, would free. Run in a subprocess, so that a deadlock fails the
    test instead of hanging it."""
    import subprocess
    import sys
    big, small = _cloud(n=200000, seed=1), _cloud(n=20, seed=2)
    paths = [str(tmp_path / f"p{i}.ply") for i in range(4)]
    write_ply(paths[0], *big)
    for p in paths[1:]:
        write_ply(p, *small)
    code = (
        "import sys\n"
        "from real_robot_nerf_actor_tpu_torch.data import native_loader\n"
        "with native_loader.NativePrefetcher(max_num_coords=200000, n_workers=2,\n"
        "                                    capacity=1) as pf:\n"
        "    for p in sys.argv[1:]:\n"
        "        pf.submit(p)\n"
        "    n = [int(pf.next()[2].sum()) for _ in sys.argv[1:]]\n"
        "print(n)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native_loader.get_lib()   # build outside the timed subprocess
    try:
        out = subprocess.run([sys.executable, "-c", code, *paths], cwd=root,
                             capture_output=True, text=True, timeout=60)
    except subprocess.TimeoutExpired:
        pytest.fail("the prefetcher deadlocked")
    want = [int((np.linalg.norm(c[0], axis=-1) < 3).sum()) for c in (big, small, small, small)]
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)


def test_native_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native_loader.build()


def test_native_build_raises_on_a_compile_error(monkeypatch, tmp_path):
    bad = tmp_path / "ply_loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SRC", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build"):
        native_loader.build()
    assert not any((tmp_path / "build").iterdir())   # no half-written library


def test_native_source_is_the_ports_own_copy():
    import real_robot_nerf_actor_tpu_torch
    port = os.path.dirname(real_robot_nerf_actor_tpu_torch.__file__)
    assert native_loader.SRC.is_file()
    assert str(native_loader.SRC) == os.path.join(port, "csrc", "ply_loader.cpp")
    assert str(native_loader.BUILD_DIR) == os.path.join(port, ".build")
