"""Time the fkcc kernel of one source tree on the card, at the shapes each
path of the port launches it with.

    python vamp_mvt_tpu_torch/bench/time_fkcc.py [--tree DIR] [--label NAME]
        [--shape T,G ...] [--sweep]

Imports `vamp_mvt_tpu_torch` from `--tree` (default: the checkout holding
this file), so that an older tree unpacked beside it (`git archive`) can be
timed by the same script; run parent, change, change, parent in one call to
compare two versions on one card.  The inputs come from this checkout's
`bench/scenes.py` whatever the tree, so every tree is timed on the same
tensors.  Each time is the median of 20 CUDA-event timed launches after 3
warm-ups, on these cases (B problems x N configurations):

  bench_validity   run_suite's start and goal validity on the 700 seeded
                   sphere cages (mbm._valid_fused), rows layout, 700 x 2
  bench_direct     its direct-goal check (validate_motion_batch at the
                   span's point bound), lanes layout, 700 x 440
  primitives       chip_smoke.py's kernel phase: 700 MBM-shaped scenes x
                   1024 seeded configurations, lanes layout
  api_rrtc_step    one lockstep step of panda.rrtc in the API's payload
                   cage: K + C = 12 segments of `num` points (rrtc.py's
                   n_points_bound at the API's range), rows layout, 1 x 480
  prm_samples      one sample wave of panda.prm in the sphere cage, 1 x 64
  prm_edges        one edge wave of panda.prm in the sphere cage: 210
                   seeded edges (PRM's largest wave there) at the full-span
                   point count, lanes layout, 1 x 92,400
  fcit_edge        one popped edge of panda.fcit, lanes layout, 1 x 440
  clouds64         the first 64 MBM-shaped scenes as clouds (10,000 samples
                   an object, the kernel form) x 1024 configurations
  attach700        700 sphere cages with seeded payloads x 1024
  terrain700       700 Panda terrains (250 x 250 cells) x 1024
  sphere_api_step  one lockstep step of sphere.rrtc over the API's maze,
                   rows layout, 1 x 12 num
  ur5_draw, fetch_draw, baxter_draw
                   chip_smoke.py's suite_robots draw: 2048 MBM-shaped scenes
                   (seed 10) x 1024 configurations (seeds 20, 21, 22), rows
                   layout

`ms` includes the wrapper's host work between the two events (checks,
table arguments, output allocation, the launch call), as a caller sees it;
`device_ms` is the card's time alone: ten launches captured in a CUDA
graph, the median replay over ten (null for a tree whose wrapper copies
host tables to the card inside a launch, which a graph cannot capture).  Each
case carries the launch's shape and occupancy (`LAST_LAUNCH`, where the
tree has it).  `--shape T,G` also times every case at that launch shape,
and `--sweep` at every shape that fits (where the tree's wrappers take
one); a shape's validity must equal the default's (on a pointcloud, outside
the contact band).  Prints one JSON line with the card's name and power
limit.
"""

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

CONTACT_BAND = 1e-5
PRM_EDGES = 210        # the largest edge wave of panda.prm in the sphere cage
STEP_SEGMENTS = 12     # K + C of the API's lockstep planner (8 + 4)
ROBOT_DRAWS = ("ur5_draw", "fetch_draw", "baxter_draw")


def load_scenes():
    """This checkout's bench/scenes.py as a module of its own, importing the
    package from wherever sys.path finds it."""
    spec = importlib.util.spec_from_file_location("_time_fkcc_scenes",
                                                  Path(__file__).with_name("scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_block(spec, rng, lo, hi, rrt_range, device):
    """One lockstep step's block of configurations: STEP_SEGMENTS seeded
    segments from points between lo and hi (plus up to 0.1 of noise), each
    of length up to rrt_range, at rrtc.py's point count for that range,
    (1, STEP_SEGMENTS * num, d) in the rows layout the planner launches."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.planning import validate

    num = validate.n_points_bound(spec, rrt_range)
    d = spec.dimension
    u = rng.uniform(0.0, 1.0, (STEP_SEGMENTS, 1))
    starts = np.asarray(lo) + (np.asarray(hi) - np.asarray(lo)) * u + rng.uniform(
        -0.1, 0.1, (STEP_SEGMENTS, d))
    dirs = rng.standard_normal((STEP_SEGMENTS, d))
    dirs *= rng.uniform(0.2, 1.0, (STEP_SEGMENTS, 1)) * rrt_range / np.linalg.norm(
        dirs, axis=1, keepdims=True)
    s = torch.as_tensor(starts.astype(np.float32), device=device)[None]
    g = torch.as_tensor((starts + dirs).astype(np.float32), device=device)[None]
    return validate.motion_configs(spec, s, g, num).transpose(1, 2).contiguous()


def path_cases(dev, names=None) -> dict:
    """{name: (spec, envs, q, layout)} for the cases of the module doc (all,
    or `names`); q is (B, N, d) for the rows layout, (B, d, N) for lanes."""
    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm, profile_suite
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.pointcloud import pipeline
    from vamp_mvt_tpu_torch.robots import registry

    scenes = load_scenes()
    names = set(names or ("bench_validity", "bench_direct", "primitives", "api_rrtc_step",
                          "prm_samples", "prm_edges", "fcit_edge", "clouds64", "attach700",
                          "terrain700", "sphere_api_step") + ROBOT_DRAWS)
    spec = registry.load("panda")
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    num_long = validate.n_points_bound(spec, span)
    out = {}
    if names & {"bench_validity", "bench_direct", "attach700"}:
        c_envs, st, gl, _ = mbm.build_batch(mbm.cage_suite(700)["problems"]["cage"],
                                            device=dev)
        out["bench_validity"] = (spec, c_envs, torch.cat([st[:, None], gl], 1).contiguous(),
                                 "rows")
        out["bench_direct"] = (spec, c_envs, validate.motion_configs(
            spec, st[:, None].expand_as(gl).contiguous(), gl, num_long).contiguous(), "lanes")
    q1024 = torch.as_tensor(np.random.default_rng(2).uniform(
        spec.limits_low, spec.limits_high, (700, 1024, spec.dimension)).astype(np.float32),
        device=dev)
    if "primitives" in names:
        envs = mbm.build_batch(scenes.mbm_shaped_problems(700, seed=1), device=dev)[0]
        out["primitives"] = (spec, envs, q1024.transpose(1, 2).contiguous(), "lanes")
    if names & {"api_rrtc_step", "prm_samples", "prm_edges", "fcit_edge"}:
        cage, A, B = profile_suite.api_cage()
        rng = np.random.default_rng(11)
        rrt_range = vmt.panda.default_rrtc_settings().range
        out["api_rrtc_step"] = (spec, cage.build(dev).map(lambda t: t[None]),
                                _step_block(spec, rng, A, B, rrt_range, dev), "rows")
        plain = vmt.Environment()
        for c in mbm.CAGE_CENTERS:
            plain.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
        p_envs = plain.build(dev).map(lambda t: t[None])
        draw = lambda n: torch.as_tensor(rng.uniform(  # noqa: E731
            spec.limits_low, spec.limits_high, (1, n, spec.dimension)).astype(np.float32),
            device=dev)
        out["prm_samples"] = (spec, p_envs, draw(64), "rows")
        out["prm_edges"] = (spec, p_envs, validate.motion_configs(
            spec, draw(PRM_EDGES), draw(PRM_EDGES), num_long).contiguous(), "lanes")
        out["fcit_edge"] = (spec, p_envs, validate.motion_configs(
            spec, draw(1), draw(1), num_long).contiguous(), "lanes")
    if "clouds64" in names:
        pc = [dict(p, sphere=[]) for p in scenes.mbm_shaped_problems(64, seed=1)]
        envs = envmod.stack_environments([envmod.EnvironmentBuilder(
            pck=pipeline.problem_to_pointcloud_env("panda", p, pc_repr="capt",
                                                   samples_per_object=10000)[0].pck)
            .build(device="cpu") for p in pc]).to(dev)
        out["clouds64"] = (spec, envs, q1024[:64].contiguous(), "rows")
    if "attach700" in names:
        a_envs = c_envs._replace(attachment=scenes.payloads(700, 6, spec, dev))
        out["attach700"] = (spec, a_envs, q1024.transpose(1, 2).contiguous(), "lanes")
    if "terrain700" in names:
        ts = scenes.mbm_shaped_problems(700, seed=7)
        for p in ts:
            p.update(sphere=p["sphere"][:1], cylinder=p["cylinder"][:2], box=p["box"][:2])
        hm, hd = scenes.terrain_tables(700, 8, dev)
        t_envs = mbm.build_batch(ts, device=dev)[0]._replace(hf_meta=hm, hf_data=hd)
        out["terrain700"] = (spec, t_envs, q1024.transpose(1, 2).contiguous(), "lanes")
    if "sphere_api_step" in names:
        terrain = vmt.Environment()
        terrain.add_heightfield(*envmod.make_heightfield(
            *scenes.MAZE_META, scenes.maze(np.random.default_rng(41))))
        sspec = vmt.sphere.spec
        out["sphere_api_step"] = (sspec, terrain.build(dev).map(lambda t: t[None]), _step_block(
            sspec, np.random.default_rng(12), [-4.0, -4.0, 1.0], [4.0, 4.0, 1.0],
            vmt.sphere.default_rrtc_settings().range, dev), "rows")
    if names & set(ROBOT_DRAWS):
        envs = mbm.build_batch(scenes.mbm_shaped_problems(2048, seed=10), device=dev)[0]
        for i, robot in enumerate(("ur5", "fetch", "baxter")):
            rspec = registry.load(robot)
            out[f"{robot}_draw"] = (rspec, envs, scenes.seeded_configs(rspec, 2048, 1024, 20 + i,
                                                                       dev), "rows")
    return {k: v for k, v in out.items() if k in names}


def launcher(spec, envs, q, layout):
    """The path's launch: fn(**kw) -> (B, N) bool validity."""
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    fn = fkcc_cuda.fkcc_batched if layout == "rows" else fkcc_cuda.fkcc_batched_lanes
    return lambda **kw: fn(spec, envs, q, **kw)


def time_launch(fn, warmup: int = 3, reps: int = 20) -> tuple[float, list]:
    """Median milliseconds of `fn` over `reps` CUDA-event timed calls."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def graph_ms(fn, per_graph: int = 10, warmup: int = 2, reps: int = 5) -> float:
    """Device milliseconds of one call of `fn`: `per_graph` calls captured in
    one CUDA graph, the median of `reps` replays over `per_graph` (so the
    graph's own launch, some 10 us, is spread over the calls)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    return time_launch(g.replay, warmup, reps)[0] / per_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--shape", action="append", default=[],
                    help="T,G: also time every case at this launch shape")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every case at every launch shape that fits")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from vamp_mvt_tpu_torch.ops.kernels import build, fkcc_cuda

    if not torch.cuda.is_available():
        raise SystemExit("time_fkcc needs a CUDA device")
    dev = torch.device("cuda")
    takes_shape = "shape" in inspect.signature(fkcc_cuda.fkcc_batched).parameters
    # an older wrapper copies host tables to the card inside a launch, which a
    # CUDA graph cannot capture
    capturable = hasattr(fkcc_cuda, "_table_pack")
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] if takes_shape else []
    if args.sweep and takes_shape:
        shapes += [(T, G) for T in fkcc_cuda.MEGA_THREADS for G in fkcc_cuda.MEGA_GROUPS
                   if G <= T and (T, G) not in shapes]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "tree": args.tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "cases": {}}
    for name, (spec, envs, q, layout) in path_cases(dev).items():
        fn = launcher(spec, envs, q, layout)
        ref = fn()
        torch.cuda.synchronize()
        ms, each = time_launch(fn)
        B, N = q.shape[0], q.shape[1] if layout == "rows" else q.shape[2]
        rec = {"B": B, "N": N, "layout": layout, "ms": ms, "each_ms": each,
               "occupancy": dict(getattr(fkcc_cuda, "LAST_LAUNCH", {})) or None,
               "device_ms": graph_ms(fn) if capturable else None}
        if shapes:
            vp = None
            rec["shapes"] = {}
            for shape in shapes:
                key = f"{shape[0]},{shape[1]}"
                try:
                    got = fn(shape=shape)
                except ValueError as e:  # a shape that does not fit this case
                    rec["shapes"][key] = {"refused": str(e)}
                    continue
                diff = got != ref
                if envs.pck is not None and bool(diff.any()):  # sign-exact there
                    if vp is None:
                        qr = q if layout == "rows" else q.transpose(1, 2)
                        vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, qr)
                    diff &= vp.abs() > CONTACT_BAND
                s_ms, _ = time_launch(lambda: fn(shape=shape))
                rec["shapes"][key] = {"ms": s_ms, "mismatches": int(diff.sum()),
                                      "occupancy": dict(fkcc_cuda.LAST_LAUNCH),
                                      "device_ms": graph_ms(lambda: fn(shape=shape))}
        out["cases"][name] = rec
    out["ptxas"] = build.ptxas_lines("fkcc")
    print(json.dumps(out), flush=True)
    bad = [(n, k) for n, r in out["cases"].items() for k, s in r.get("shapes", {}).items()
           if s.get("mismatches")]
    if bad:
        raise SystemExit(f"time_fkcc: validity differs from the default shape at {bad}")
    return out


if __name__ == "__main__":
    main()
