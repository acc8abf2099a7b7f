"""Problem -> pointcloud -> filtered cloud -> pointcloud environment.

Port of `vamp_mvt_tpu/pointcloud/pipeline.py` (reference
src/vamp/pointcloud.py:129-183, problem_dict_to_pointcloud): sample the
problem's cylinder and box surfaces, filter (SCDF or center-selective voxel)
and build the requested structure (MVT or CAPT), with the per-stage timings
of the reference's benchmarking plumbing; `kernel_pc` also builds the form
the CUDA kernels read (collision/pc_kernel.py).  Under a runner's recorder
(utils/profiling.py) the stages are the spans pc_sample, pc_filter,
pc_build_mvt or pc_build_capt, and pc_build_kernel.
"""

from __future__ import annotations

import time

import numpy as np

from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision.pc_kernel import radius_classes
from vamp_mvt_tpu_torch.pointcloud import filters, sampling
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.utils import profiling

# reference src/vamp/constants.py:11-23
ROBOT_FIRST_JOINT_LOCATIONS = {
    "baxter": [0.0, 0.0, 0.0],
    "fetch": [0.0, 0.0, 0.4],
    "ur5": [0.0, 0.0, 0.91],
    "panda": [0.0, 0.0, 0.0],
}
ROBOT_MAX_RADII = {"baxter": 1.31, "ur5": 1.2, "fetch": 1.5, "panda": 1.19}
POINT_RADIUS = 0.0025


def problem_to_pointcloud_env(
    robot: str,
    problem: dict,
    pc_repr: str = "mvt",
    samples_per_object: int = 10000,
    filter_type: str = "scdf",
    filter_radius: float = 0.02,
    voxel_filter_size: float = 0.0308,
    filter_cull: bool = True,
    builder: envmod.EnvironmentBuilder | None = None,
    pad: dict | None = None,
    kernel_pc: bool = True,
    use_native: bool = True,
):
    """Returns (builder, original_pc, filtered_pc, filter_ns, build_ns).

    `builder`, when given, receives the cloud beside what it holds already
    (and is the builder returned).  `pad` pads the structures to a batch's
    maxima: pad_voxels / pad_capacity for MVT, pad_leaves / pad_capacity
    for CAPT, and pc_pad_chunks for the kernel form's chunks.
    kernel_pc=True also builds the kernel-resident structure, and its build
    time counts in build_ns (it is part of the per-problem preprocessing,
    like the reference's CAPT/MVT builds).  use_native picks the C++ filters
    and builds (vamp_mvt_tpu_torch/native.py) or the numpy ones."""
    if pc_repr not in ("mvt", "capt"):
        raise ValueError(f"unknown pointcloud representation {pc_repr!r}")
    if filter_type not in ("scdf", "centervox"):
        raise ValueError(f"unknown filter {filter_type!r}")
    spec = registry.load(robot)

    with profiling.span("pc_sample"):
        original = sampling.problem_to_pointcloud(problem, samples_per_object)

    origin = ROBOT_FIRST_JOINT_LOCATIONS.get(robot, [0.0, 0.0, 0.0])
    cull_radius = ROBOT_MAX_RADII.get(robot, 1.4)
    bbox_lo = np.asarray(origin) - cull_radius
    bbox_hi = np.asarray(origin) + cull_radius

    with profiling.span("pc_filter"):
        t0 = time.perf_counter_ns()
        if filter_type == "scdf":
            filtered = filters.filter_scdf(original, filter_radius, cull_radius, origin,
                                           bbox_lo, bbox_hi, filter_cull, use_native=use_native)
        else:
            filtered = filters.filter_centervox(original, voxel_filter_size, cull_radius,
                                                origin, bbox_lo, bbox_hi, use_native=use_native)
        filter_ns = time.perf_counter_ns() - t0

    b = envmod.EnvironmentBuilder() if builder is None else builder
    pad = dict(pad or {})
    pc_pad_chunks = pad.pop("pc_pad_chunks", None)
    with profiling.span("pc_build_" + pc_repr):
        if pc_repr == "mvt":
            build_ns = b.add_mvt_pointcloud(filtered, spec.min_radius, spec.max_radius,
                                            bbox_lo, bbox_hi, POINT_RADIUS, **pad)
        else:
            build_ns = b.add_capt_pointcloud(filtered, spec.min_radius, spec.max_radius,
                                             POINT_RADIUS, use_native=use_native, **pad)
    if kernel_pc:
        with profiling.span("pc_build_kernel"):
            build_ns += b.add_kernel_pointcloud(
                filtered, radius_classes(spec.sphere_radius), bbox_lo, bbox_hi,
                POINT_RADIUS, float(spec.max_radius), pad_chunks=pc_pad_chunks,
                use_native=use_native)
    return b, original, filtered, filter_ns, build_ns
