"""CLI + offline viz smoke tests (flag parity with the reference CLI)."""

import os

import numpy as np
import pytest

from pathtracerpython_tpu.cli.main import main, setup


def test_flags_match_reference_surface():
    """The reference's flags (main.py:125-139) all parse."""
    args = setup([
        "scene.sdl", "--out", "x.png", "-r", "4", "-b", "3",
        "--show-img", "--show-scene", "--show-normals", "--show-screen",
        "--show-inter",
    ])
    assert args.scene == "scene.sdl"
    assert args.rays_per_pixel == 4
    assert args.bounces == 3
    assert args.show_img and args.show_scene and args.show_normals
    assert args.show_screen and args.show_inter


def test_honor_sdl_fields(cornell_sdl, tmp_path, capsys):
    """--honor-sdl uses the SDL's npaths/seed/tonemapping (cornellroom.sdl:
    npaths 10, seed 9, tonemapping 1.0); explicit flags still win."""
    out = str(tmp_path / "o.png")
    rc = main([
        cornell_sdl, "--out", out, "-b", "1", "--honor-sdl", "--metrics",
    ])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "n_samples=10" in captured      # SDL npaths honored
    import json

    metrics = json.loads(
        [l for l in captured.splitlines() if l.startswith("{")][-1]
    )
    # rays_attempted = 40*40*10spp*1bounce*(1+3)
    assert metrics["counters"]["rays_attempted"] == 40 * 40 * 10 * 4

    # explicit -r beats the SDL value
    rc = main([
        cornell_sdl, "--out", out, "-b", "1", "-r", "2", "--honor-sdl",
        "--quiet",
    ])
    assert rc == 0


def test_background_paid_on_miss():
    """use_background: a miss lane pays the scene background color."""
    import dataclasses

    import jax.numpy as jnp

    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.integrator import render
    from tests.test_diff import make_flat_scene

    scene = dataclasses.replace(
        make_flat_scene(), background=jnp.asarray([0.1, 0.2, 0.3])
    )
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1)
    r_off = np.asarray(render(scene, cfg, seed=0))
    r_on = np.asarray(
        render(scene, dataclasses.replace(cfg, use_background=True), seed=0)
    )
    miss = (r_off == 0.0).all(axis=1)  # black pixels = guaranteed misses
    assert miss.any()
    np.testing.assert_allclose(
        r_on[miss],
        np.broadcast_to([0.1, 0.2, 0.3], r_on[miss].shape),
        atol=1e-6,
    )
    np.testing.assert_allclose(r_on[~miss], r_off[~miss], atol=1e-6)


def test_render_to_png(cornell_sdl, tmp_path):
    out = str(tmp_path / "o.png")
    rc = main([cornell_sdl, "--out", out, "-r", "1", "-b", "1", "--quiet"])
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (40, 40, 3)
    assert img.max() > 0


def test_debug_view_written(cornell_sdl, tmp_path):
    out = str(tmp_path / "o.png")
    rc = main([
        cornell_sdl, "--out", out, "-r", "1", "-b", "1", "--quiet",
        "--show-scene", "--show-inter",
    ])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "o_scene.png"))


def test_sharded_render_flag(cornell_sdl, tmp_path):
    out = str(tmp_path / "o.png")
    rc = main([
        cornell_sdl, "--out", out, "-r", "1", "-b", "1", "--quiet",
        "--dp", "4", "--geom", "2",
    ])
    assert rc == 0
    assert os.path.exists(out)


def test_chunked_progress_lines(cornell_sdl, tmp_path, capsys):
    """--chunk-spp prints one status line per chunk (the batched analogue
    of the reference's tqdm bars, main.py:199-224) and --quiet silences
    them."""
    out = str(tmp_path / "o.png")
    rc = main([
        cornell_sdl, "--out", out, "-r", "8", "-b", "1",
        "--chunk-spp", "4",
    ])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    prog = [ln for ln in lines if ln.startswith("chunk ")]
    assert len(prog) == 2, lines
    assert "1/2" in prog[0] and "2/2" in prog[1]
    assert "Mrays/s" in prog[0]

    rc = main([
        cornell_sdl, "--out", out, "-r", "8", "-b", "1",
        "--chunk-spp", "4", "--quiet",
    ])
    assert rc == 0
    assert capsys.readouterr().out == ""

