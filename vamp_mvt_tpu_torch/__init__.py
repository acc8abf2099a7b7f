"""vamp_mvt_tpu_torch — the PyTorch / CUDA port of vamp_mvt_tpu.

The module layout mirrors the JAX package (`robots`, `sampling`,
`collision`, `ops`, `planning`, `bench`, and the user API `api`); the fused
FK + collision check runs as a hand-written CUDA kernel for Hopper
(`csrc/fkcc.cu`) and every kernel keeps a plain PyTorch version that the CPU
uses.  Entry points run on the GPU unless the caller passes `device="cpu"`.
Importing the package builds no kernel.  This package never imports `jax`
or `vamp_mvt_tpu`.
"""

from vamp_mvt_tpu_torch.api import (  # noqa: F401
    ROBOTS,
    AORRTCSettings,
    Attachment,
    Capsule,
    Cuboid,
    Cylinder,
    Environment,
    FCITSettings,
    Halton,
    PRMNeighborParams,
    PRMSettings,
    RobotModule,
    RRTCSettings,
    SimplifySettings,
    Sphere,
    baxter,
    fetch,
    panda,
    png_to_heightfield,
    sphere,
    ur5,
)

robots = ROBOTS
