"""Traffic kind `cloud_query`: a robot that replans from each new cloud.

Each request hands one problem to the port's pointcloud suite runner,
`bench/mbm.py::run_suite_pointcloud(batch_size=1)`: on the host it samples
the cylinders and boxes, filters and builds the cloud; on the card it checks
the endpoints, plans (with the runner's 16x retry) and simplifies."""

from __future__ import annotations

import dataclasses

import numpy as np

from planbench.queries import QueryDriver
from planbench.reference import cloud


class Driver(QueryDriver):
    def prepare(self, run):
        from vamp_mvt_tpu_torch.bench import mbm

        self.mbm = mbm
        c = self.config
        self.settings = dataclasses.replace(mbm.pointcloud_settings(c["robot"]),
                                            **c.get("settings", {}))

    def ask(self, run, p) -> dict:
        c = self.config
        with run.span("run_suite_pointcloud"):
            res, tm = self.mbm.run_suite_pointcloud(
                c["robot"], pc_repr=c["pc_repr"], filter_type=c["filter"],
                settings=self.settings, batch_size=1,
                samples_per_object=c["samples_per_object"], warmup=False,
                data={"robot": c["robot"], "problems": {p["problem"]: [p]}},
                device=run.device)
        valid = bool(res.valid[0])
        solved = bool(res.plan.solved[0]) and valid
        parts = (res.plan, res.simplified)
        paths = [np.asarray(part.path[0][:int(part.path_length[0])]) for part in parts]
        return {"valid": valid, "solved": solved, "paths": paths,
                "costs": [float(part.cost[0]) for part in parts],
                "cost": float(res.simplified.cost[0]), "timings": tm["phases"],
                "filter_build_ns": float(np.sum(tm["filter_ns"]) + np.sum(tm["build_ns"]))}

    def scene(self, p):
        """The reference's own filtered cloud of a problem (made once)."""
        c = self.config
        clouds = self.__dict__.setdefault("clouds", {})
        if id(p) not in clouds:
            clouds[id(p)] = cloud.problem_cloud(p, c["samples_per_object"], c["filter_radius"],
                                                c["reach"], c["origin"])
        return clouds[id(p)]

    def scene_kind(self, scenes):
        return ("clouds", scenes, self.config["point_radius"])
