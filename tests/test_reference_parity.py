"""End-to-end radiance parity: our reference-mode renderer vs radiance
captured from the ACTUAL reference program (scripts/generate_reference_golden
runs /root/reference/main.py serially and records the per-pixel float sums).

RNG streams differ (CPython Mersenne vs counter-based threefry), so
converged renders are compared statistically: the Monte-Carlo mean of both
estimators is the same quantity, so with S samples the per-pixel difference
shrinks as 1/sqrt(S). Deterministic structure (which pixels see the light,
the ambient floor) must match exactly.
"""

import os

import numpy as np
import pytest

from pathtracerpython_tpu.render import RenderConfig, render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load_golden(r, b, seed=9):
    path = os.path.join(GOLDEN_DIR, f"reference_r{r}_b{b}_seed{seed}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden not generated: {path}")
    return np.load(path)["radiance"]  # [1600, 3] float64, x-outer order


def test_light_pixels_and_ambient_floor_match_exactly(cornell_scene):
    """Deterministic structure of the b=1 estimator."""
    golden = _load_golden(1, 1)
    ours = np.asarray(
        render(cornell_scene, RenderConfig(mode="reference", n_samples=1,
                                           n_bounces=1), seed=0)
    )
    # pixels whose primary ray hits the light pay exactly light_color
    gold_light = np.all(golden == 1.0, axis=1)
    ours_light = np.all(ours == 1.0, axis=1)
    np.testing.assert_array_equal(ours_light, gold_light)
    # both have the same hit-vs-background structure (zero radiance lanes)
    np.testing.assert_array_equal(
        np.all(ours == 0.0, axis=1), np.all(golden == 0.0, axis=1)
    )


def test_converged_radiance_allclose_b1(cornell_scene):
    """BASELINE gate: allclose on converged radiance (single bounce)."""
    golden = _load_golden(64, 1)
    ours = np.asarray(
        render(cornell_scene, RenderConfig(mode="reference", n_samples=64,
                                           n_bounces=1), seed=9)
    )
    # MC noise at 64 spp over 3 NEE samples: per-pixel sigma ~ 0.3/sqrt(192)
    diff = np.abs(ours - golden)
    assert diff.mean() < 0.01, diff.mean()
    assert np.quantile(diff, 0.99) < 0.08, np.quantile(diff, 0.99)
    corr = np.corrcoef(ours.ravel(), golden.ravel())[0, 1]
    assert corr > 0.998, corr


def test_converged_radiance_bias_bound_b2(cornell_scene):
    """Multi-bounce BIAS gate (replaces the round-1 self-noise ceiling).

    Three independent reference runs (r64/b2, seeds 9/10/11 — generated
    by scripts/generate_reference_golden.py) are averaged into R̄, three
    of our own seeds into Ō (192 spp effective each). For UNBIASED
    estimators of the same quantity, the per-pixel means differ by
    N(0, 2σ²/3), so E|Ō − R̄| = d_self/√3 exactly, where d_self is the
    mean pairwise |diff| between our own single runs (E|x−y| = 2σ/√π).
    Averaged over 4800 pixel-channels the fluctuation of these means is
    ~1.5%, so the 1.15 gate margin fails any systematic estimator bias
    exceeding ~0.55× the (√3-reduced) per-pixel noise floor — a bound on
    BIAS, not a ceiling proportional to our own noise.
    """
    goldens = [_load_golden(64, 2, seed=s) for s in (9, 10, 11)]
    cfg = RenderConfig(mode="reference", n_samples=64, n_bounces=2)
    ours = [
        np.asarray(render(cornell_scene, cfg, seed=s)) for s in (9, 123, 456)
    ]
    d_self = np.mean([
        np.abs(ours[i] - ours[j]).mean()
        for i, j in ((0, 1), (0, 2), (1, 2))
    ])
    ours_mean = np.mean(ours, axis=0)
    gold_mean = np.mean(goldens, axis=0)
    diff = np.abs(ours_mean - gold_mean)
    floor = d_self / np.sqrt(3.0)
    assert diff.mean() < floor * 1.15, (diff.mean(), floor)
    corr = np.corrcoef(ours_mean.ravel(), gold_mean.ravel())[0, 1]
    assert corr > 0.999, corr


def test_baseline_config0_shape(tmp_path):
    """The literal BASELINE configs[0] gate: 128x128, 16 spp, 2 bounces,
    reference semantics, against full reference-program captures at the
    same shape (scripts/generate_reference_golden.py 16 2 SEED <sdl-128>).

    De-flaked (r3): BOTH sides average over every available seed. For
    unbiased estimators of the same quantity with matched per-pixel
    variance sigma^2, the mean-of-m vs mean-of-k difference is
    N(0, sigma^2 (1/m + 1/k)) per pixel while our own seed-to-seed
    E|diff| measures |N(0, 2 sigma^2)| — so the exact noise floor is
    d_self * sqrt((1/m + 1/k) / 2). Averaged over 49k pixel-channels the
    statistic fluctuates ~0.3%/sqrt(mk), so the 1.05 margin bounds
    systematic bias without a realistic flake tail."""
    import shutil

    goldens = []
    for s in (9, 10, 11):
        path = os.path.join(
            GOLDEN_DIR, f"reference_r16_b2_seed{s}_128x128.npz"
        )
        if os.path.exists(path):
            goldens.append(np.load(path)["radiance"])
    if not goldens:
        pytest.skip("no 128x128 goldens generated")

    from pathtracerpython_tpu.scene import cornell_sdl

    sdl_dir = tmp_path / "objs"
    shutil.copytree(os.path.dirname(cornell_sdl()), sdl_dir)
    sdl = sdl_dir / "cornellroom.sdl"
    text = sdl.read_text().replace("size 40 40", "size 128 128")
    assert "size 128 128" in text
    sdl.write_text(text)

    from pathtracerpython_tpu.scene import load_scene

    scene = load_scene(str(sdl))
    assert scene.meta.width == scene.meta.height == 128
    cfg = RenderConfig(mode="reference", n_samples=16, n_bounces=2)
    ours = [
        np.asarray(render(scene, cfg, seed=s)) for s in (9, 123, 456)
    ]
    d_self = np.mean([
        np.abs(ours[i] - ours[j]).mean()
        for i, j in ((0, 1), (0, 2), (1, 2))
    ])
    m, k = len(ours), len(goldens)
    ours_mean = np.mean(ours, axis=0)
    gold_mean = np.mean(goldens, axis=0)
    floor = d_self * np.sqrt((1.0 / m + 1.0 / k) / 2.0)
    diff = np.abs(ours_mean - gold_mean)
    assert diff.mean() < floor * 1.05, (diff.mean(), floor, m, k)
    corr = np.corrcoef(ours_mean.ravel(), gold_mean.ravel())[0, 1]
    self_corr = np.corrcoef(ours[0].ravel(), ours[1].ravel())[0, 1]
    assert corr > self_corr - 0.002, (corr, self_corr)


def test_converged_radiance_bias_bound_b4(cornell_scene):
    """North-star-depth BIAS gate (VERDICT r4 task 4): same methodology
    as the b=2 gate — three independent reference captures at r64/b4
    (seeds 9/10/11) averaged into R̄, three of our own seeds into Ō; for
    unbiased estimators of the same quantity E|Ō − R̄| = d_self/√3, so
    the 1.15 margin bounds systematic bias at ~0.55x the √3-reduced
    per-pixel noise floor. Four bounces compound every reference-mode
    scatter quirk (y-axis frames, Phong-toward-eye, TAU, numpy power
    semantics — /root/reference/main.py:192-268), which the b=2 gate
    only exercised through two rounds of compounding; this is the
    BASELINE configs[1] bounce depth."""
    goldens = [_load_golden(64, 4, seed=s) for s in (9, 10, 11)]
    cfg = RenderConfig(mode="reference", n_samples=64, n_bounces=4)
    ours = [
        np.asarray(render(cornell_scene, cfg, seed=s)) for s in (9, 123, 456)
    ]
    d_self = np.mean([
        np.abs(ours[i] - ours[j]).mean()
        for i, j in ((0, 1), (0, 2), (1, 2))
    ])
    ours_mean = np.mean(ours, axis=0)
    gold_mean = np.mean(goldens, axis=0)
    diff = np.abs(ours_mean - gold_mean)
    floor = d_self / np.sqrt(3.0)
    assert diff.mean() < floor * 1.15, (diff.mean(), floor)
    corr = np.corrcoef(ours_mean.ravel(), gold_mean.ravel())[0, 1]
    # noise-referenced correlation gate (a fixed 0.999 overdemands at
    # b=4 variance): with single-run self-correlation ρ = Vs/(Vs+Vn),
    # two INDEPENDENT 3-seed means correlate at Vs/(Vs+Vn/3) — measured
    # here ρ≈0.997 on both sides (ours AND the reference's own seeds),
    # expected ≈0.99900, observed 0.99893. Gate at expected − 5e-4
    # (~7σ of the corr estimator over 4800 pixel-channels): flakes
    # can't trip it, structural decorrelation (≫1e-3) still fails.
    rho = np.mean([
        np.corrcoef(ours[i].ravel(), ours[j].ravel())[0, 1]
        for i, j in ((0, 1), (0, 2), (1, 2))
    ])
    expected = 1.0 / (1.0 + (1.0 - rho) / (3.0 * rho))
    assert corr > expected - 5e-4, (corr, expected, rho)
