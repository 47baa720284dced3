"""Real multi-process ``jax.distributed`` run (VERDICT r3 task 2).

The reference crosses process boundaries every bounce — a
``multiprocessing.Pool`` pickling scene data per task
(``/root/reference/main.py:197-228``). Our replacement is JAX's
multi-controller runtime (``parallel/multihost.py``); this test executes
its DISTRIBUTED branch for real: two subprocesses, a localhost
coordinator, a cross-process 4-device CPU mesh, ``render_sharded`` over
it (pure dp AND a dp x geom ppermute ring that crosses the process
boundary), ``fetch_to_host`` via ``process_allgather``, and ``sync`` —
then bit-compares against the single-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.heavy

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_renders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    # The worker must import pathtracerpython_tpu even when the package
    # is NOT pip-installed: extend PYTHONPATH with the repo root.
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(tmp / f"worker{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), "2", outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [np.load(o) for o in outs]


def test_two_process_render_bitmatches_single(
    multihost_renders, cornell_sdl
):
    from pathtracerpython_tpu.render import RenderConfig, render
    from pathtracerpython_tpu.scene import load_scene

    scene = load_scene(cornell_sdl, pad_to=32)
    single = np.asarray(
        render(scene, RenderConfig(mode="fast", n_samples=2, n_bounces=2),
               seed=3)
    )
    for worker_imgs in multihost_renders:
        img_dp, img_ring = worker_imgs[0], worker_imgs[1]
        # dp over a cross-process mesh: bit-identical (RNG keyed by
        # global pixel id — parallel/shard.py docstring contract)
        np.testing.assert_array_equal(img_dp, single)
        # dp x geom with the ring ppermute crossing processes
        np.testing.assert_array_equal(img_ring, single)


def test_both_processes_assembled_identically(multihost_renders):
    # process_allgather must hand every process the same full image
    np.testing.assert_array_equal(multihost_renders[0], multihost_renders[1])
