"""The port's SfM readers against the JAX package's, on the synthetic files
of tests/test_io.py: every case is read by both packages and must give the
same views (K, R and t within 1e-12, equal worldpoint lists, image paths,
sizes, distortion and median depth), and every malformed file the same
ValueError text."""

import json
import struct

import numpy as np
import pytest

from line3dpp_tpu import io as jio
from line3dpp_tpu_torch import io as tio


def _nvm(p):
    f = p / "result.nvm"
    f.write_text(
        "NVM_V3\n\n2\n"
        "img0.jpg 1000 1 0 0 0  1 2 3  0.05 0\n"
        "img1.jpg 1100 0.9238795 0 0.3826834 0  4 5 6  0 0\n"
        "\n2\n"
        "0 0 10  255 0 0  2  0 0 5 5  1 0 6 6\n"
        "1 1 12  0 255 0  1  0 1 7 7\n")
    return "read_nvm", (str(f),)


def _colmap_text(p):
    (p / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500 510 320 240\n"
        "2 SIMPLE_RADIAL 640 480 520 320 240 0.1\n")
    (p / "images.txt").write_text(
        "# comment\n"
        "7 0.9238795 0.0 0.3826834 0.0 0.1 0.2 0.3 1 a.jpg\n1 1 -1\n"
        "8 1 0 0 0 0 0 1 2 b.jpg\n\n")
    (p / "points3D.txt").write_text(
        "# comment\n5 0 0 10 255 255 255 0.5 7 1 8 1\n")
    return "read_colmap", (str(p), "/imgs")


def _colmap_binary(p):
    with open(p / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        f.write(struct.pack("<dddd", 500, 510, 320, 240))
        f.write(struct.pack("<iiQQ", 2, 2, 640, 480))
        f.write(struct.pack("<dddd", 520, 320, 240, 0.1))
    with open(p / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<i", 7))
        f.write(struct.pack("<dddd", 0.9238795, 0.0, 0.3826834, 0.0))
        f.write(struct.pack("<ddd", 0.1, 0.2, 0.3))
        f.write(struct.pack("<i", 1))
        f.write(b"a.jpg\x00")
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<ddq", 1.0, 1.0, -1))
        f.write(struct.pack("<i", 8))
        f.write(struct.pack("<dddd", 1, 0, 0, 0))
        f.write(struct.pack("<ddd", 0, 0, 1))
        f.write(struct.pack("<i", 2))
        f.write(b"b.jpg\x00")
        f.write(struct.pack("<Q", 0))
    with open(p / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<q", 5))
        f.write(struct.pack("<ddd", 0, 0, 10))
        f.write(struct.pack("<BBB", 255, 255, 255))
        f.write(struct.pack("<d", 0.5))
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ii", 7, 1))
        f.write(struct.pack("<ii", 8, 1))
    return "read_colmap", (str(p), "/imgs")


def _colmap_empty_observations(p):
    (p / "cameras.txt").write_text("1 PINHOLE 640 480 500 510 320 240\n")
    (p / "images.txt").write_text(
        "7 1 0 0 0 0.1 0.2 0.3 1 a.jpg\n\n"
        "8 1 0 0 0 0 0 1 1 b.jpg\n1 1 -1\n")
    return "read_colmap", (str(p), "/imgs")


def _bundler(p):
    f = p / "bundle.rd.out"
    f.write_text(
        "# Bundle file v0.3\n1 1\n800 0.01 0.001\n"
        "1 0 0\n0 1 0\n0 0 1\n1 2 3\n"
        "0 0 -10\n255 255 255\n1 0 0 1.5 2.5\n")
    (p / "a.jpg").write_bytes(b"")
    return "read_bundler", (str(f), str(p))


def _openmvg(p):
    data = {
        "root_path": "/imgs",
        "views": [{"key": 0, "value": {"ptr_wrapper": {"data": {
            "id_view": 0, "id_pose": 0, "id_intrinsic": 0,
            "filename": "a.jpg", "local_path": "", "width": 640,
            "height": 480}}}}],
        "intrinsics": [{"key": 0, "value": {"ptr_wrapper": {"data": {
            "focal_length": 900.0, "principal_point": [320.0, 240.0],
            "width": 640, "height": 480, "disto_k1": [0.02]}}}}],
        "extrinsics": [{"key": 0, "value": {
            "rotation": np.eye(3).tolist(), "center": [1.0, 0.0, 0.0]}}],
        "structure": [{"key": 11, "value": {
            "X": [0.0, 0.0, 9.0],
            "observations": [{"key": 0, "value": {}}]}}],
    }
    f = p / "sfm_data.json"
    f.write_text(json.dumps(data))
    return "read_openmvg", (str(f),)


def _mavmap(p):
    f = p / "image-data-1.txt"
    f.write_text(
        "# header\n"
        "img0, 0, 0, 0, 47.0, 15.0, 100, 0, 1, 2, 3, 0, PINHOLE, "
        "500, 510, 320, 240\n")
    return "read_mavmap", (str(f), str(p))


def _mavmap_truncated(p):
    f = p / "image-data-3.txt"
    f.write_text("img0, 0, 0, 0, 47.0, 15.0, 100, 0, 1, 2, 3\n")
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    return "read_mavmap", (str(f), str(p), K)


def _pix4d(p):
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    (p / "proj_calibrated_camera_parameters.txt").write_text(
        "Pix4D camera calibration file\n\nimg0.jpg 640 480\n"
        "500 0 320\n0 510 240\n0 0 1\n0.01 0.002 0.0003\n0.0001 0.00002\n"
        "1.0 2.0 3.0\n"
        + "\n".join(" ".join(str(x) for x in row) for row in R) + "\n")
    return "read_pix4d", (str(p), "/imgs")


def _pix4d_tracks(p):
    X = np.array([0.0, 0.0, 5.0])
    K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    recs, obs = [], []
    for i in range(3):
        C = np.array([0.5 * i, 0.0, 0.0])
        x_cam = X - C
        uv = (K @ (x_cam / x_cam[2]))[:2]
        recs.append(
            f"img{i}.jpg 100 100\n100 0 50\n0 100 50\n0 0 1\n"
            f"0 0 0\n0 0\n{C[0]} {C[1]} {C[2]}\n1 0 0\n0 1 0\n0 0 1\n")
        obs.append(f"img{i}\nfeatA {uv[0]} {uv[1]} 1.0\n")
    (p / "proj_calibrated_camera_parameters.txt").write_text(
        "header\n\n" + "".join(recs))
    (p / "proj_tp_pix4d.txt").write_text("".join(obs))
    return "read_pix4d", (str(p), "/imgs")


def _nvm_truncated(p):
    f = p / "trunc.nvm"
    f.write_text("NVM_V3\n\n5\nimg0.jpg 800 1 0 0 0")
    return "read_nvm", (str(f),)


def _bundler_garbage(p):
    f = p / "bundle.rd.out"
    f.write_text("# Bundle file v0.3\n2 0\nnot_a_number 0 0\n")
    return "read_bundler", (str(f), str(p), [])


def _mavmap_not_pinhole(p):
    f = p / "image-data-2.txt"
    f.write_text("img0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 0, OPENCV, "
                 "500, 510, 320, 240\n")
    return "read_mavmap", (str(f), str(p))


CASES = {
    "nvm": _nvm, "colmap_text": _colmap_text,
    "colmap_binary": _colmap_binary,
    "colmap_empty_observations": _colmap_empty_observations,
    "bundler": _bundler, "openmvg": _openmvg, "mavmap": _mavmap,
    "mavmap_truncated": _mavmap_truncated, "pix4d": _pix4d,
    "pix4d_tracks": _pix4d_tracks,
}
MALFORMED = {
    "nvm_truncated": (_nvm_truncated, "malformed NVM"),
    "bundler_garbage": (_bundler_garbage, "malformed bundler"),
    "mavmap_not_pinhole": (_mavmap_not_pinhole, "malformed mavmap"),
}


def _assert_same_views(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == "SfMView"
        assert g.cam_id == w.cam_id and g.image_path == w.image_path
        assert (g.width, g.height) == (w.width, w.height)
        for k in ("K", "R", "t"):
            np.testing.assert_allclose(getattr(g, k), getattr(w, k),
                                       rtol=0, atol=1e-12)
        if w.distortion is None:
            assert g.distortion is None
        else:
            np.testing.assert_array_equal(g.distortion, w.distortion)
        assert g.worldpoints == w.worldpoints
        assert g.median_depth == pytest.approx(w.median_depth, rel=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_reader_matches_jax(tmp_path, case):
    reader, args = CASES[case](tmp_path)
    _assert_same_views(getattr(tio, reader)(*args),
                       getattr(jio, reader)(*args))


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_file_raises_the_same_error(tmp_path, case):
    build, text = MALFORMED[case]
    reader, args = build(tmp_path)
    with pytest.raises(ValueError, match=text) as got:
        getattr(tio, reader)(*args)
    with pytest.raises(ValueError) as want:
        getattr(jio, reader)(*args)
    assert str(got.value) == str(want.value)


def test_sequential_neighbors_match_jax():
    from line3dpp_tpu.io.mavmap import sequential_neighbors

    for n, window in ((5, 4), (12, 10), (3, 1)):
        assert tio.sequential_neighbors(n, window) == \
            sequential_neighbors(n, window)
    assert set(tio.__all__) >= set(jio.__all__) | {"sequential_neighbors"}
