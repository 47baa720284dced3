#!/usr/bin/env python3
"""Smoke test of the path tracer's main paths on one NVIDIA GPU.

    python chip_smoke.py            # one card: every single-card phase
    python chip_smoke.py --four     # four cards: the sharded checks only

Phases (one card):

1. device      — a GPU is required; prints its kind, the device count and
                 ``nvidia-smi``'s name and power limit;
2. cornell     — the CLI renders the Cornell box at 512², 4 spp, 4
                 bounces, 3 NEE samples (fast mode) and writes the PNG; the
                 kernel and XLA sweep renders are timed; the same program
                 on the host CPU at 64², 2 spp is compared;
3. boxfield    — the 100k-triangle box field at 512², 2 spp, 3 bounces on
                 the path the code picks; the Triton sweep is compared with
                 the XLA sweep on one primary and one NEE wavefront, and both
                 renders are timed;
4. inverse     — three albedo train steps on Cornell 128² (loss must drop),
                 the gradient against the CPU at 32², and a soft-visibility
                 render against the CPU.

Reference mode is not compared with the captured reference radiance
(``tests/golden``) here: the packaged Cornell box is a reconstruction
whose box geometry does not reproduce those captures.

``--four`` runs only the sharded checks, each against a one-card render.
Every phase prints its compile and run seconds and what it compared. The
last line is ``{"ok": true, "device": {...}}``; any failure raises and the
exit code is non-zero. Comparisons are stated with their tolerance and its
reason next to the check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
PACKAGE = os.path.join(REPO, "pathtracerpython_tpu")


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def report(phase: str, compile_s: float, run_s: float, what: str) -> None:
    print(f"[{phase}] compile_s={compile_s:.3f} run_s={run_s:.3f} {what}",
          flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the cards, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def aot(fn, *args):
    """(compiled, compile seconds) of ``jax.jit(fn)`` for ``args``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def run(compiled, *args):
    """(result, seconds) of one call, waited for with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, time.perf_counter() - t0


def median_time(compiled, args_for, reps: int) -> float:
    """Median seconds of ``reps`` calls after one warm-up; ``args_for(i)``
    varies an input (the seed) so no call repeats another."""
    run(compiled, *args_for(0))
    times = [run(compiled, *args_for(i + 1))[1] for i in range(reps)]
    return float(np.median(times))


def close_share(a, b, rtol: float, atol: float) -> float:
    """Share of rows (pixels) whose every channel agrees."""
    a = np.asarray(a).reshape(a.shape[0], -1)
    b = np.asarray(b).reshape(b.shape[0], -1)
    return float(np.isclose(a, b, rtol=rtol, atol=atol).all(axis=1).mean())


def diff_profile(a, b) -> str:
    """Worst and mean per-pixel |a - b| and the share of pixels within
    1e-6, 1e-4, 1e-3 and 1e-1: rounding noise sits in the first bins, a
    path whose decision flipped in the last ones."""
    a = np.asarray(a).reshape(a.shape[0], -1)
    b = np.asarray(b).reshape(b.shape[0], -1)
    worst = np.abs(a - b).max(axis=1)
    bins = " ".join(f"<={tol:g}:{(worst <= tol).mean():.5f}"
                    for tol in (1e-6, 1e-4, 1e-3, 1e-1))
    return (f"max|diff|={worst.max():.3e} mean|diff|="
            f"{np.abs(a - b).mean():.3e} pixels {bins}")


# Two compilations of one render (card and CPU, or the two sweeps) draw
# the same counter-based samples, so a pixel agrees to PIXEL_TOL unless
# one of its paths takes another discrete decision on the last bit. The
# common one is NEE's: a shadow ray that leaves a surface almost parallel
# to it (from the ceiling towards the light 0.0056 below it) re-hits its
# own surface just beyond the 1e-4 near-clip on one rounding of its
# origin and not on the other; 207 of 12288 shadow rays of the Cornell
# 64x64 primary wavefront flip between two roundings of the camera ray
# directions on the CPU. Such a flip moves its pixel by about the grazing
# cosine (<= 1e-2) times the light, so at most 3% of pixels may fall
# outside PIXEL_TOL and the mean |diff| stays below 5e-4.
PIXEL_TOL = 1e-3
MIN_CLOSE_SHARE = 0.97
MAX_MEAN_DIFF = 5e-4


def renders_agree(what: str, a, b):
    """(report text, check) for two renders under the rule above."""
    share = close_share(a, b, rtol=PIXEL_TOL, atol=PIXEL_TOL)
    mean = float(np.abs(np.asarray(a) - np.asarray(b)).mean())
    text = (f"{what}: {share:.5f} of pixels within {PIXEL_TOL:g} (need >= "
            f"{MIN_CLOSE_SHARE}, mean|diff| < {MAX_MEAN_DIFF:g}), "
            f"{diff_profile(a, b)}")

    def verdict():
        check(share >= MIN_CLOSE_SHARE and mean < MAX_MEAN_DIFF,
              f"{what}: share {share}, mean|diff| {mean}")

    return text, verdict


def render_medians(scene, cfg, reps: int):
    """{"kernel" | "xla": (median render seconds of ``reps``, radiance at
    seed 0, compile seconds, compiled)} of ``render(scene, cfg)`` on the
    sweeps the code picks, then with ``geometry.use_sweep_kernel`` patched
    to keep every sweep on XLA."""
    import jax.numpy as jnp

    from pathtracerpython_tpu.ops import geometry
    from pathtracerpython_tpu.render import render

    seeds = lambda i: (scene, jnp.uint32(i))
    out = {}
    picks = geometry.use_sweep_kernel
    try:
        for name, rule in (("kernel", picks), ("xla", lambda *a: False)):
            geometry.use_sweep_kernel = rule
            # a new function object, so jit traces again under the rule
            fn = lambda sc, seed: render(sc, cfg, seed=seed)
            comp, c_s = aot(fn, scene, jnp.uint32(0))
            rad, _ = run(comp, scene, jnp.uint32(0))
            out[name] = (median_time(comp, seeds, reps), np.asarray(rad),
                         c_s, comp)
    finally:
        geometry.use_sweep_kernel = picks
    return out


def resized(scene, size: int):
    return dataclasses.replace(
        scene, meta=dataclasses.replace(scene.meta, width=size, height=size)
    )


def read_png(path: str) -> np.ndarray:
    """Decode the 8-bit RGB, filter-0 PNGs ``render.image.save_png``
    writes."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    check((raw[:, 0] == 0).all(), "unexpected PNG filter")
    return raw[:, 1:].reshape(h, w, 3)


def cpu_device():
    import jax

    return jax.devices("cpu")[0]


def on_device(dev, fn, *args):
    """(result, compile seconds, run seconds) of ``jax.jit(fn)(*args)``
    on ``dev``. CPU programs skip the persistent compile cache: a cache
    shared between hosts can hand this host CPU code built for another
    one's instruction set (XLA warns that it may SIGILL on load)."""
    import jax

    cached = jax.config.jax_enable_compilation_cache
    if dev.platform == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
    try:
        with jax.default_device(dev):
            args = on(dev, args)
            comp, c_s = aot(fn, *args)
            out, r_s = run(comp, *args)
    finally:
        jax.config.update("jax_enable_compilation_cache", cached)
    return out, c_s, r_s


def on(device, tree):
    import jax

    return jax.device_put(tree, device)


# -- phases -----------------------------------------------------------------


def phase_device():
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {dev.platform} "
            f"({dev.device_kind})"
        )
    print(f"device_kind={dev.device_kind} count={len(devices)}", flush=True)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    return dev


def phase_cornell(card, out_dir: str, size: int = 512, spp: int = 4,
                  bounces: int = 4, cmp_size: int = 64, cmp_spp: int = 2,
                  reps: int = 5):
    """CLI render at full size on ``card``; kernel vs XLA sweep render
    times; the same program on the CPU at a reduced size."""
    import jax

    from pathtracerpython_tpu.cli.main import main as cli_main
    from pathtracerpython_tpu.render import RenderConfig, render
    from pathtracerpython_tpu.render.image import radiance_to_image
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    scene_dir = os.path.join(out_dir, "scene")
    shutil.copytree(os.path.dirname(cornell_sdl()), scene_dir,
                    dirs_exist_ok=True)
    sdl = os.path.join(scene_dir, "cornellroom.sdl")
    with open(sdl) as f:
        text = f.read().replace("size 40 40", f"size {size} {size}")
    with open(sdl, "w") as f:
        f.write(text)
    png = os.path.join(out_dir, f"cornell_{size}.png")

    t0 = time.perf_counter()
    with jax.default_device(card):
        rc = cli_main([sdl, "--out", png, "-r", str(spp), "-b", str(bounces),
                       "--light-samples", "3", "--mode", "fast", "--seed",
                       "0", "--chunk-spp", "0", "--quiet"])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"CLI exit code {rc}")
    img = read_png(png)
    check(img.shape == (size, size, 3), f"PNG shape {img.shape}")

    # the CLI's program: its sample plan and its morton-ordered scene
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                       n_light_samples=3)
    scene = on(card, load_scene(sdl, tri_order="morton"))
    with jax.default_device(card):
        timed = render_medians(scene, cfg, reps)
    t_k, rad, c_s, _ = timed["kernel"]
    t_x, rad_x, cx_s, _ = timed["xla"]
    check(np.isfinite(rad).all(), "non-finite radiance")
    # radiance is a sum of light_color-weighted throughputs: the light
    # itself pays 1.0, throughput factors (kd + ks) are at most 1.6 per
    # bounce, so a 4-bounce Cornell pixel stays far below 50
    check(rad.min() >= 0.0 and rad.max() < 50.0,
          f"radiance range [{rad.min()}, {rad.max()}]")
    check(0.05 < rad.mean() < 5.0, f"mean radiance {rad.mean()}")
    lsb = np.abs(img.astype(int)
                 - radiance_to_image(rad, size, size).astype(int))
    # the CLI and the jitted render run the same program; allow 1 LSB for
    # last-bit differences between the two compilations
    png_share = float((lsb.max(axis=2) <= 1).mean())
    report("cornell", c_s, t_k,
           f"{size}x{size} {spp}spp {bounces}b on the kernel sweep: "
           f"cli_wall_s={cli_s:.3f} radiance [{rad.min():.4f}, "
           f"{rad.max():.4f}] mean={rad.mean():.5f} "
           f"png_within_1lsb={png_share:.5f} (need >= 0.999)")
    check(png_share >= 0.999, f"CLI PNG vs render: {png_share}")
    # both sweeps apply the same first-minimum rule to the same
    # Möller–Trumbore arithmetic; only FMA contraction differs
    text, verdict = renders_agree("kernel vs XLA radiance", rad, rad_x)
    report("cornell", c_s, t_k,
           f"render median of {reps}: kernel={t_k:.5f}s xla={t_x:.5f}s "
           f"(xla compile_s={cx_s:.3f}); {text}")
    verdict()

    small = resized(load_scene(sdl, tri_order="morton"), cmp_size)
    cfg_s = dataclasses.replace(cfg, n_samples=cmp_spp)
    fn_s = lambda sc: render(sc, cfg_s, seed=0)
    got, c_g, r_g = on_device(card, fn_s, small)
    want, _, _ = on_device(cpu_device(), fn_s, small)
    # RNG streams are counter-based, so both devices draw the same
    # samples; only rounding differs (FMA contraction, transcendental
    # ulps), which moves a pixel by ~1e-6 unless a hit flips on a grazing
    # or tied triangle. 1e-3 per channel absorbs rounding; at most 1% of
    # pixels may hold a flipped path.
    text, verdict = renders_agree(
        f"card vs CPU at {cmp_size}x{cmp_size} {cmp_spp}spp", got, want)
    report("cornell", c_g, r_g, text)
    verdict()
    return rad


def _shadow_wavefront(scene, o3, d3u, t, hit, n_light: int, key):
    """One NEE wavefront: from every primary hit point, ``n_light`` rays
    toward uniformly sampled light points (the integrator's layout,
    [3, n_light * N])."""
    import jax
    import jax.numpy as jnp

    from pathtracerpython_tpu.ops import sampling
    from pathtracerpython_tpu.ops.geometry import normalize3

    n = o3.shape[1]
    p3 = o3 + d3u * t[None, :]
    u = jax.random.uniform(key, (n_light, 3, n))
    tri = sampling.pick_light_triangle(u[:, 0], scene.light_area)
    b = sampling.cm_sample_barycentric_uniform(jnp.moveaxis(u[:, 1:3], 1, 0))
    lv = [getattr(scene, f"light_v{k}")[tri] for k in range(3)]  # [S,N,3]
    lp3 = sampling.cm_point_from_barycentric(
        b, *(jnp.moveaxis(v, -1, 0) for v in lv)
    )
    vec3 = lp3 - p3[:, None, :]
    dist = jnp.sqrt(jnp.sum(vec3 * vec3, axis=0))
    # misses shoot from far outside the scene and hit nothing
    park = jnp.where(hit[None, None, :], 0.0, 1e6)
    so3 = jnp.broadcast_to(p3[:, None, :] + park, vec3.shape)
    return (so3.reshape(3, -1), normalize3(vec3).reshape(3, -1),
            dist.reshape(-1))


def compare_sweeps(t_k, i_k, t_x, i_x, t_rtol: float = 1e-5):
    """(share of rays whose winner differs, worst relative t gap among
    equal winners). A different winner is allowed only on a tie or a
    grazing hit: both t agree to 1e-4 relative, or one side misses."""
    t_k, i_k, t_x, i_x = map(np.asarray, (t_k, i_k, t_x, i_x))
    same = i_k == i_x
    both = same & (i_k >= 0)
    gap = float(np.max(np.abs(t_k[both] - t_x[both])
                       / np.maximum(np.abs(t_x[both]), 1e-6), initial=0.0))
    check(gap <= t_rtol, f"t differs by {gap} rel on equal winners")
    diff = ~same
    tie = diff & (i_k >= 0) & (i_x >= 0) & (
        np.abs(t_k - t_x) <= 1e-4 * np.maximum(np.abs(t_x), 1e-6))
    graze = diff & ((i_k < 0) | (i_x < 0))
    check((tie | graze)[diff].all(), "winners differ beyond ties/grazing")
    return float(diff.mean()), gap


def phase_boxfield(card, size: int = 512, spp: int = 2, bounces: int = 3,
                   n_boxes: int = 8333, reps: int = 5,
                   interpret: bool = False):
    """The 100k box field on the code's path; Triton vs XLA sweeps on the
    card at full width; kernel vs XLA render times."""
    import jax
    import jax.numpy as jnp

    from pathtracerpython_tpu.kernels import intersect_triton as kt
    from pathtracerpython_tpu.ops import geometry
    from pathtracerpython_tpu.ops.camera import make_primary_rays
    from pathtracerpython_tpu.render import RenderConfig, render
    from pathtracerpython_tpu.scene.arrays import pack_scene
    from pathtracerpython_tpu.scene.synthetic import box_field_scene

    desc = box_field_scene(n_boxes=n_boxes, width=size, height=size)
    scene = on(card, pack_scene(desc, morton_order=True))
    n_tri = scene.meta.n_triangles
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                       n_light_samples=3, batch_samples=True)

    with jax.default_device(card):
        o, d = make_primary_rays(scene.eye, scene.ortho, size, size)
        o3 = jnp.asarray(o.T)
        d3u = geometry.normalize3(jnp.asarray(d.T))

        xla_nearest = lambda o3_, d3_, sc: geometry._nearest_t_idx_xla(
            o3_, d3_, sc, cfg.tile)
        k_nearest = lambda o3_, d3_, sc: kt.nearest_t_idx_cm(
            o3_, d3_, sc, interpret=interpret)
        ck, ck_s = aot(k_nearest, o3, d3u, scene)
        (t_k, i_k), rk_s = run(ck, o3, d3u, scene)
        cx, cx_s = aot(xla_nearest, o3, d3u, scene)
        (t_x, i_x), rx_s = run(cx, o3, d3u, scene)
        flip, gap = compare_sweeps(t_k, i_k, t_x, i_x)
        report("boxfield", ck_s, rk_s,
               f"primary wavefront {o3.shape[1]} rays x {n_tri} tris: "
               f"kernel vs XLA winners differ on {flip:.2e} of rays "
               f"(ties/grazing only), t max rel gap {gap:.2e} (<=1e-5); "
               f"XLA sweep compile_s={cx_s:.3f} run_s={rx_s:.3f}")

        hit = i_x >= 0
        so3, sd3, sdist = _shadow_wavefront(
            scene, o3, d3u, t_x, hit, 3, jax.random.PRNGKey(7)
        )
        sk, sk_c = aot(k_nearest, so3, sd3, scene)
        (st_k, si_k), sk_r = run(sk, so3, sd3, scene)
        sx, _ = aot(xla_nearest, so3, sd3, scene)
        (st_x, si_x), sx_r = run(sx, so3, sd3, scene)
        flip_s, gap_s = compare_sweeps(st_k, si_k, st_x, si_x)
        k_any = lambda a, b, m, sc: kt.any_hit_cm(a, b, m, sc,
                                                  interpret=interpret)
        x_any = lambda a, b, m, sc: geometry.any_hit_within(
            a.T, b.T, m, sc, tile=cfg.tile)
        ak, ak_c = aot(k_any, so3, sd3, sdist, scene)
        occ_k, ak_r = run(ak, so3, sd3, sdist, scene)
        ax, _ = aot(x_any, so3, sd3, sdist, scene)
        occ_x, ax_r = run(ax, so3, sd3, sdist, scene)
        # occlusion flips only where a blocker grazes the shadow ray or
        # sits within rounding of the light distance
        occ_flip = float((np.asarray(occ_k) != np.asarray(occ_x)).mean())
        check(occ_flip <= 1e-3, f"any-hit bits differ on {occ_flip}")
        report("boxfield", sk_c + ak_c, sk_r + ak_r,
               f"NEE wavefront {so3.shape[1]} rays: nearest winners differ "
               f"on {flip_s:.2e} (ties/grazing only), t max rel gap "
               f"{gap_s:.2e}; any-hit bits differ on {occ_flip:.2e} "
               f"(<=1e-3); kernel any-hit run_s={ak_r:.3f} vs XLA "
               f"{ax_r:.3f}; kernel nearest run_s={sk_r:.3f} vs XLA "
               f"{sx_r:.3f}")

        timed = render_medians(scene, cfg, reps)
    t_kernel, rad, c_s, comp = timed["kernel"]
    t_xla, rad_x, cx_s, _ = timed["xla"]
    print(f"[boxfield] memory_analysis: {comp.memory_analysis()}",
          flush=True)
    text, verdict = renders_agree("kernel vs XLA radiance", rad, rad_x)
    report("boxfield", c_s, t_kernel,
           f"render {size}x{size} {spp}spp {bounces}b {n_tri} tris: "
           f"median of {reps} kernel={t_kernel:.4f}s xla={t_xla:.4f}s "
           f"(xla compile_s={cx_s:.3f}); mean radiance {rad.mean():.5f}; "
           f"{text}")
    check(np.isfinite(rad).all(), "non-finite box-field radiance")
    check(rad.min() >= 0.0 and 0.01 < rad.mean() < 5.0,
          f"box-field radiance mean {rad.mean()}")
    verdict()
    return t_kernel, t_xla


def phase_inverse(card, size: int = 128, steps: int = 3, cmp_size: int = 32):
    """Albedo train steps on the card; gradient and soft render vs CPU."""
    import jax
    import jax.numpy as jnp
    import optax

    from pathtracerpython_tpu.diff import camera_pixel_loss, make_render_fn
    from pathtracerpython_tpu.diff import make_train_step
    from pathtracerpython_tpu.render import RenderConfig, render
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    base = load_scene(cornell_sdl())
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=2)
    scene = on(card, resized(base, size))
    with jax.default_device(card):
        target = jax.jit(lambda sc: render(sc, cfg, seed=0))(scene)
        params = {"mat_rgb": scene.mat_rgb * 0.25,
                  "light_color": scene.light_color * 2.0}
        opt = optax.adam(0.05)
        step = make_train_step(opt, scene, cfg, target)
        opt_state = opt.init(params)
        key = jax.random.PRNGKey(1)
        t0 = time.perf_counter()
        comp = step.lower(params, opt_state, key).compile()
        c_s = time.perf_counter() - t0
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt_state, loss = comp(params, opt_state,
                                           jax.random.fold_in(key, i))
            losses.append(float(loss))
        r_s = time.perf_counter() - t0
    report("inverse", c_s, r_s,
           f"{steps} albedo steps at {size}x{size}: loss "
           + " -> ".join(f"{x:.5f}" for x in losses))
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not drop: {losses}")

    small = resized(base, cmp_size)
    tgt = jnp.zeros((cmp_size * cmp_size, 3))
    pids = jnp.arange(cmp_size * cmp_size, dtype=jnp.int32)
    p0 = {"mat_rgb": small.mat_rgb * 0.5, "light_color": small.light_color}

    def grad_fn(p, sc, t):
        return jax.grad(camera_pixel_loss)(
            p, sc, t, make_render_fn(cfg), pids, jax.random.PRNGKey(3))

    g_card, gc, gr = on_device(card, grad_fn, p0, small, tgt)
    g_cpu, _, _ = on_device(cpu_device(), grad_fn, p0, small, tgt)
    # a gradient sums over every pixel: rounding differences average
    # out, and a flipped path moves the sum by one path's share (1 of
    # 2048 here), so 2% of the gradient's scale bounds both
    errs = {k: float(np.abs(np.asarray(g_card[k]) - np.asarray(g_cpu[k])).max()
                     / max(np.abs(np.asarray(g_cpu[k])).max(), 1e-12))
            for k in p0}
    report("inverse", gc, gr,
           f"grad vs CPU at {cmp_size}x{cmp_size}: rel err "
           + " ".join(f"{k}={e:.2e}" for k, e in errs.items()) + " (<2e-2)")
    check(max(errs.values()) < 2e-2, f"grad rel errs {errs}")

    soft = RenderConfig(mode="fast", n_samples=2, n_bounces=2,
                        soft_vis_beta=0.05)
    soft_fn = lambda sc: render(sc, soft, seed=0)
    r_card, sc_c, sr_c = on_device(card, soft_fn, small)
    r_cpu, _, _ = on_device(cpu_device(), soft_fn, small)
    # the hard render's rule: the soft blend is continuous, but NEE's
    # grazing shadow rays flip as they do there
    text, verdict = renders_agree(
        f"soft render (beta=0.05, 2spp, 2b, sample scan) vs CPU at "
        f"{cmp_size}x{cmp_size}", r_card, r_cpu)
    report("inverse", sc_c, sr_c, text)
    verdict()


def phase_four(size: int = 128):
    """render_sharded on dp=4 and on dp=2 x geom=2, and one data-parallel
    train step, each against one card."""
    import jax
    import optax

    from pathtracerpython_tpu.diff import make_train_step
    from pathtracerpython_tpu.parallel import make_mesh, render_sharded
    from pathtracerpython_tpu.render import RenderConfig, render
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    one = devices[0]
    scene = resized(load_scene(cornell_sdl()), size)
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=3)
    with jax.default_device(one):
        # the README's claim is against plain render(), which runs the
        # same per-bounce programs as the sharded render
        single = np.asarray(render(on(one, scene), cfg, seed=1))
    results = {}
    for name, mesh, geom in (
        ("dp4", make_mesh(dp=4, devices=devices[:4]), None),
        ("dp2_geom2", make_mesh(dp=2, geom=2, devices=devices[:4]), "geom"),
    ):
        t0 = time.perf_counter()
        out = np.asarray(render_sharded(scene, cfg, mesh, seed=1,
                                        geom_axis=geom))
        wall = time.perf_counter() - t0
        exact = bool(np.array_equal(out, single))
        # RNG is keyed by global pixel id, so each shard runs the one-card
        # program on its pixels. The geometry ring sweeps its triangle
        # shards with XLA where one card runs the culled kernel, so its
        # hits may differ in the last bit: the render rule applies
        text, verdict = renders_agree(
            f"render_sharded {name} vs one card: bit_identical={exact}",
            out, single)
        results[name] = exact
        report("four", 0.0, wall, text)
        verdict()

    target = on(one, jax.numpy.zeros((size * size, 3)))
    params = {"mat_rgb": scene.mat_rgb * 0.5}
    opt = optax.sgd(0.0)

    def one_step(mesh):
        step = make_train_step(opt, scene, cfg, target, mesh=mesh)
        _, _, loss = step(params, opt.init(params), jax.random.PRNGKey(2))
        return float(loss)

    from pathtracerpython_tpu.diff import camera_pixel_loss, make_render_fn

    pids = jax.numpy.arange(size * size, dtype=jax.numpy.int32)

    def grads(mesh):
        rf = make_render_fn(cfg, mesh)
        fn = jax.jit(jax.grad(lambda p: camera_pixel_loss(
            p, scene, target, rf, pids, jax.random.PRNGKey(2))))
        return np.asarray(fn(params)["mat_rgb"])

    t0 = time.perf_counter()
    with jax.default_device(one):
        g1 = grads(None)
    g4 = grads(make_mesh(dp=4, devices=devices[:4]))
    wall = time.perf_counter() - t0
    exact = bool(np.array_equal(g1, g4))
    # the dp gradient is a psum of per-shard partial sums: another
    # summation order than one card's, so allclose at f32 rounding
    loss4 = one_step(make_mesh(dp=4, devices=devices[:4]))
    report("four", 0.0, wall,
           f"dp=4 grads vs one card: bit_identical={exact} allclose "
           f"rtol=1e-4 atol=1e-7, max|diff|={np.abs(g4 - g1).max():.3e}; "
           f"dp=4 train step loss={loss4:.6f}")
    check(np.allclose(g4, g1, rtol=1e-4, atol=1e-7),
          f"dp grads differ: {np.abs(g4 - g1).max()}")
    check(np.isfinite(loss4), f"dp train step loss {loss4}")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded checks")
    args = p.parse_args(argv)
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the CPU comparisons run in this process beside the card
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    if not os.path.isdir(PACKAGE):
        raise SystemExit(f"chip_smoke.py runs from a checkout: no {PACKAGE}")
    # the checkout's package, never another installed copy
    sys.path.insert(0, REPO)

    import jax

    from pathtracerpython_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    dev = phase_device()
    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    if args.four:
        phase_four()
    else:
        phase_cornell(dev, OUT_DIR)
        phase_boxfield(dev)
        phase_inverse(dev)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
