"""Worker process for the multi-process jax.distributed test.

Launched by tests/test_distributed.py as ``python distributed_worker.py
<process_id> <num_processes> <port> <outdir>``.  Each process contributes 4
virtual CPU devices to a global 8-device mesh via a localhost coordinator —
the same ``jax.distributed.initialize`` + process-spanning-mesh path a real
multi-host deployment uses (SURVEY.md §5.8, docs/multihost.md), with Gloo
standing in for DCN.  Renders the tiny three-spheres preset over the global
(tiles, spp) mesh and writes the assembled image to <outdir>/img_<pid>.npy.
"""
import os
import sys


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # Importing the package must NOT initialize the XLA backend (that
    # would break jax.distributed.initialize) — geometry constants are
    # deliberately numpy scalars; this worker is the regression test.
    from first_raytracer.parallel.mesh import (initialize_distributed,
                                               make_render_mesh)

    initialize_distributed(coordinator=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)

    from first_raytracer.parallel.shard import render_image_distributed
    from first_raytracer.scene.builders import three_spheres
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 4 * nproc

    scene, cam, cfg = three_spheres(nx=24, ny=12, spp=2)
    mesh = make_render_mesh(num_tile_shards=2 * nproc, num_spp_shards=2)
    img = render_image_distributed(scene, cam, cfg, mesh, seed=0)

    import numpy as np
    np.save(os.path.join(outdir, f"img_{pid}.npy"), img)


if __name__ == "__main__":
    main()
