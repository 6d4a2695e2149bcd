"""Real multi-process coverage for the distributed path (SURVEY.md §4.5d):
two OS processes, each with 4 virtual CPU devices, joined by
``jax.distributed.initialize`` over a localhost coordinator into one
8-device mesh.  The sharded render must match the single-process render
exactly (the RNG is keyed by global ray id, so the image is invariant to
how the mesh spans processes) — this is the only part of the multi-host
story that fake-multidevice tests cannot reach: process-spanning meshes,
cross-process collectives (Gloo standing in for DCN), and the
``process_allgather`` image assembly."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_images(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dist"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "distributed_worker.py"),
             str(pid), "2", str(port), outdir],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return [np.load(os.path.join(outdir, f"img_{pid}.npy"))
            for pid in range(2)]


def test_two_process_render_matches_single_process(worker_images):
    """Global-mesh render across 2 processes == single-process render."""
    from first_raytracer.parallel.mesh import make_render_mesh
    from first_raytracer.parallel.shard import render_image_distributed
    from first_raytracer.scene.builders import three_spheres

    scene, cam, cfg = three_spheres(nx=24, ny=12, spp=2)
    mesh = make_render_mesh(num_tile_shards=4, num_spp_shards=2)
    ref = render_image_distributed(scene, cam, cfg, mesh, seed=0)
    for pid, img in enumerate(worker_images):
        assert img.shape == ref.shape
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6,
                                   err_msg=f"process {pid}")


def test_both_processes_agree(worker_images):
    """Every process assembles the identical full image (the allgather
    returns the same global pixels everywhere)."""
    np.testing.assert_array_equal(worker_images[0], worker_images[1])
