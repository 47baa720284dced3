"""Per-phase device time of one Cornell render, from a profiler trace.

Traces one warm render of the packaged Cornell box (512², 4 spp, 4
bounces, 3 NEE samples, fast mode, all samples in one wavefront) on the
first device and reduces the trace to device time per integrator phase:
``nearest_hit``, ``nee`` and ``scatter`` (the ``jax.named_scope`` names in
``render/integrator.py``), the rest, and the device's idle share of the
traced window. Prints one JSON line; ``--out`` keeps the raw trace.

A kernel is attributed through the compiled program's HLO: the trace
names each launch's HLO instruction (``hlo_op``), and the instruction's
``op_name`` metadata carries the scope path. XLA's command buffers
(CUDA graphs) hide the instruction behind the buffer, so this script
turns them off for its own process; the render is timed by ``bench.py``,
not here.

    python scripts/profile_cornell.py [--out chiprun_out/profile]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("nearest_hit", "nee", "scatter")
_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M)


def scope_of(hlo_text: str) -> dict[str, str]:
    """{HLO instruction name: phase} from a compiled program's text."""
    out = {}
    for name, op_name in _OP_NAME.findall(hlo_text):
        out[name] = next((ph for ph in PHASES if f"/{ph}/" in op_name
                          or op_name.endswith(f"/{ph}")), "other")
    return out


def reduce_trace(path: str, phase_of: dict[str, str],
                 device_prefix: str = "/device:GPU:0") -> dict:
    """{phase: device seconds, ..., "busy_s", "window_s", "idle_share",
    "top_kernels"} from an ``.xplane.pb`` file. Busy is the union of the
    kernel and copy intervals on the device's stream lines; the window
    runs from the first start to the last end."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    plane = next(p for p in data.planes if p.name.startswith(device_prefix))
    out = {ph: 0.0 for ph in PHASES + ("other",)}
    spans, top = [], {}
    # kernel executions live on the stream lines; the derived "XLA Ops" /
    # "XLA Modules" lines repeat them at other granularities
    for line in plane.lines:
        if not line.name.startswith("Stream"):
            continue
        for ev in line.events:
            stats = dict(ev.stats)
            phase = phase_of.get(str(stats.get("hlo_op", "")),
                                 phase_of.get(ev.name, "other"))
            dur = ev.duration_ns * 1e-9
            out[phase] += dur
            spans.append((ev.start_ns, ev.end_ns))
            key = f"{phase}:{ev.name}"
            top[key] = top.get(key, 0.0) + dur
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    out["busy_s"] = busy * 1e-9
    out["window_s"] = window * 1e-9
    out["idle_share"] = 1.0 - busy / window if window else None
    out["top_kernels"] = sorted(top.items(), key=lambda kv: -kv[1])[:12]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="keep the trace here")
    args = p.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")

    import dataclasses

    import jax
    import jax.numpy as jnp

    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    dev = jax.devices()[0]
    scene = load_scene(cornell_sdl(), pad_to=32, tri_order="morton")
    scene = jax.device_put(dataclasses.replace(
        scene, meta=dataclasses.replace(scene.meta, width=512, height=512)))
    cfg = RenderConfig(mode="fast", n_samples=4, n_bounces=4,
                       n_light_samples=3, batch_samples=True)
    step = jax.jit(lambda sc, seed: render(sc, cfg, seed=seed))
    compiled = step.lower(scene, jnp.uint32(0)).compile()
    jax.block_until_ready(compiled(scene, jnp.uint32(0)))  # warm

    log_dir = args.out or tempfile.mkdtemp()
    jax.profiler.start_trace(log_dir)
    try:
        jax.block_until_ready(compiled(scene, jnp.uint32(1)))
    finally:
        jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    res = reduce_trace(path, scope_of(compiled.as_text()))
    res["device"] = {"platform": dev.platform, "kind": dev.device_kind}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
