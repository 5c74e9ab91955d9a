"""The port's command line, image reader and package exports against the
JAX package's, on the CPU.

The CLI check runs tests/test_cli_e2e.py's scene (5 views at 320x240, 8
lines, an NVM with worldpoints): JAX's CLI with ``--cpu`` detects the
views and writes its segment cache; the port's CLI with ``--cpu`` on the
same output folder loads those segments, detects nothing, and must write
the same four files with the same lines.  Measured here: both give the
same line count and every 3D segment within 7.8e-7 of the scene scale, so
the bound (1e-4 of the scene scale, the line count equal) leaves room for
the float32 sums of the epipolar step and nothing more.
"""

import os

import numpy as np
import pytest
import torch

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu.camera import rotation_from_rpy
from line3dpp_tpu_torch.utils import golden, images

from tests.test_cli_e2e import _render


def _scene(tmp_path):
    """test_cli_e2e's scene: JPEG views and result.nvm in ``tmp_path``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    W, H, f = 320, 240, 260.0
    P = rng.uniform([-1.5, -1.0, 5], [1.5, 1.0, 8], size=(8, 3))
    d = rng.normal(size=(8, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.8, 1.5, size=(8, 1))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    cams = []
    for i in range(5):
        R = rotation_from_rpy(0.0, -0.04 * i + 0.1, 0.0)
        C = np.array([0.4 * i - 0.8, 0.0, 0.0])
        img = _render(l3d.Camera(K, R, -R @ C, W, H), P, Q, W, H, rng)
        name = f"img{i:03d}.jpg"
        Image.fromarray(img).save(tmp_path / name, quality=95)
        qw = np.sqrt(max(1 + R[0, 0] + R[1, 1] + R[2, 2], 0)) / 2
        qx = (R[2, 1] - R[1, 2]) / (4 * qw)
        qy = (R[0, 2] - R[2, 0]) / (4 * qw)
        qz = (R[1, 0] - R[0, 1]) / (4 * qw)
        cams.append(f"{name} {f} {qw} {qx} {qy} {qz} {C[0]} {C[1]} {C[2]} "
                    f"0 0")
    pts = np.vstack([P, Q])
    wps = [f"{X[0]} {X[1]} {X[2]} 255 255 255 5 "
           + " ".join(f"{i} {j} 0 0" for i in range(5))
           for j, X in enumerate(pts)]
    nvm = tmp_path / "result.nvm"
    nvm.write_text("NVM_V3\n\n5\n" + "\n".join(cams)
                   + f"\n\n{len(pts)}\n" + "\n".join(wps) + "\n")
    return str(nvm)


ARGS = ["-n", "4", "-y", "200", "--no-optimize", "-v", "3",
        "--min_image_width", "100"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from line3dpp_tpu.cli.run import main as jax_main
    from line3dpp_tpu_torch.cli.run import main as port_main

    tmp = tmp_path_factory.mktemp("cli")
    nvm = _scene(tmp)
    out = tmp / "out"
    argv = ["vsfm", "-i", str(tmp), "-m", nvm, "-o", str(out), *ARGS]
    jax_main(argv + ["--cpu"])
    jax_files = {n: (out / n).read_bytes() for n in os.listdir(out)
                 if os.path.isfile(out / n)}
    # only the segment cache stays: every output file left is the port's
    for n in jax_files:
        os.remove(out / n)
    cache = sorted(os.listdir(out / "L3D_cache"))
    run = port_main(argv + ["--cpu"])
    port_files = {n: (out / n).read_bytes() for n in os.listdir(out)
                  if os.path.isfile(out / n)}
    return jax_files, port_files, run, cache, out


def test_cli_writes_jax_names_from_jax_segments(cli_runs):
    """JAX's outputs are removed before the port runs, so each of the four
    names is a file the port's CLI wrote itself."""
    jax_files, port_files, run, cache, out = cli_runs
    assert sorted(port_files) == sorted(jax_files)
    assert all(port_files.values())
    assert {os.path.splitext(n)[1] for n in port_files} == {
        ".txt", ".stl", ".obj", ".bin"}
    assert os.path.basename(run.base) + ".txt" in port_files
    # JAX's cache was read: nothing detected, nothing added to the cache
    assert run.pipe.detect_stats == []
    assert sorted(os.listdir(out / "L3D_cache")) == cache
    assert run.pipe.device.type == "cpu"
    assert set(run.phases) >= {"add_images_s", "match_images_s",
                               "reconstruct_3d_lines_s", "save_s"}


def test_cli_lines_match_jax(cli_runs, tmp_path):
    jax_files, port_files, run, _, _ = cli_runs
    txt = next(n for n in jax_files if n.endswith(".txt"))
    (tmp_path / "j.txt").write_bytes(jax_files[txt])
    ref = [g.segments3d for g in golden.parse_lines3d_txt(
        str(tmp_path / "j.txt"))]
    port = [l.segments3d for l in run.pipe.lines3d]
    assert len(ref) >= 4 and len(port) == len(ref)
    tol = 1e-4 * golden.scene_scale(np.concatenate(ref))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=0, atol=tol)
    (tmp_path / "p.txt").write_bytes(port_files[txt])
    assert len(golden.parse_lines3d_txt(str(tmp_path / "p.txt"))) == len(ref)


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    from line3dpp_tpu_torch.cli.run import main as port_main

    nvm = tmp_path / "result.nvm"
    nvm.write_text("NVM_V3\n\n0\n\n0\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["vsfm", "-i", str(tmp_path), "-o", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("kind", ["P5", "P6", "P6_comment"])
def test_pnm_reader_matches_pillow(tmp_path, kind):
    from PIL import Image

    rng = np.random.default_rng(1)
    if kind == "P5":
        arr = rng.integers(0, 256, (37, 53), np.uint8)
        Image.fromarray(arr).save(tmp_path / "a.pgm")
        path = tmp_path / "a.pgm"
    else:
        arr = rng.integers(0, 256, (41, 29, 3), np.uint8)
        path = tmp_path / "a.ppm"
        if kind == "P6":
            Image.fromarray(arr).save(path)
        else:
            path.write_bytes(b"P6\n# made by a test\n29 41\n# max\n255\n"
                             + arr.tobytes())
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    got = images.read_gray(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_luma_matches_pillow_on_every_grey_and_random_colours():
    from PIL import Image

    rng = np.random.default_rng(2)
    rgb = np.concatenate([
        np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1),
        rng.integers(0, 256, (200_000, 3), np.uint8)])[None]
    np.testing.assert_array_equal(
        images.rgb_to_gray(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    from PIL import Image

    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "a.png")
    images.write_pgm(str(tmp_path / "b.pgm"), np.eye(8, dtype=np.uint8))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow") as e:
        images.read_gray(str(tmp_path / "a.png"))
    assert str(tmp_path / "a.png") in str(e.value)
    np.testing.assert_array_equal(images.read_gray(str(tmp_path / "b.pgm")),
                                  np.eye(8, dtype=np.uint8))


def test_exports_cover_jax():
    assert set(l3d.__all__) <= set(lt.__all__)
    for name in lt.__all__:
        assert hasattr(lt, name), name
    assert "detect" in lt.__all__
    assert lt.io.read_nvm is not None
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 10, (160, 200))).astype(np.float32)
    img[40:44, 20:180] = 200.0
    img[60:140, 100:103] = 200.0
    np.testing.assert_array_equal(
        lt.detect_line_segments(img, device="cpu"),
        lt.detect(img, device="cpu"))
