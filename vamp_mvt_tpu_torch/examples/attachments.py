"""End-effector attachment demo (reference scripts/attachments.py): carry a
spherical payload through the sphere cage.

Port of `examples/attachments.py`, through the user API.

    python -m vamp_mvt_tpu_torch.examples.attachments [--device cpu]
"""

from __future__ import annotations

import argparse

import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu_torch.examples.sphere_cage_example import A, B, CAGE


def main(device=None) -> dict:
    env = vmt.Environment()
    for c in CAGE:
        env.add_sphere(vmt.Sphere(c, 0.2))
    env.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.12, 0.06]]))

    if not vmt.panda.validate(A, env, device=device):
        raise RuntimeError("start invalid with payload")
    res = vmt.panda.rrtc(A, B, env, device=device)
    print("solved:", bool(res.solved), "cost:", float(res.cost))
    simple = vmt.panda.simplify(res.path, res.path_length, env, device=device)
    print("simplified cost:", float(simple.cost), "vertices:", int(simple.path_length))
    return {"solved": bool(res.solved), "cost": float(res.cost),
            "simplified_cost": float(simple.cost),
            "simplified_vertices": int(simple.path_length),
            "path": simple.path[: int(simple.path_length)].cpu().numpy()}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
