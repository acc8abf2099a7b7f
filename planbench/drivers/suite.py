"""Traffic kind `suite`: a closed loop of whole MotionBenchMaker suites
through the port's suite runner, `bench/mbm.py::run_suite`, cycling a pool
of distinct suites made in set-up from the seed."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from planbench import generator, harness
from planbench.reference import check, geometry


class Driver:
    def __init__(self, run):
        self.traffic, self.config = run.cell.traffic, run.cell.config

    def setup(self, run):
        from vamp_mvt_tpu_torch.bench import mbm

        self.mbm = mbm
        pool = generator.pool(run.robot, self.traffic, self.config, run.seed, run.device)
        # a pool fixed in the traffic file is taken in an order drawn from the seed
        rng = np.random.default_rng(generator.seed_seq(run.seed, 5))
        self.suites = [generator.as_suite([p[i] for i in rng.permutation(len(p))],
                                          self.config["robot"])
                       for p in pool]
        self.pool_len = len(self.suites)
        self.order = np.random.default_rng(
            generator.seed_seq(run.seed, 3)).permutation(self.pool_len)
        self.n = int(self.traffic["problems"])
        harness.fresh_peak(run.device)
        # the runner's own warm-up (each kernel once on one problem, at both
        # budgets), then the batch's shapes on one problem whose goal is its
        # start, which the planner ends at once
        p = dict(self.suites[0][1][0])
        p["goals"] = [p["start"]]
        self._call({"robot": self.config["robot"], "problems": {p["problem"]: [p]}},
                   warmup=True, timings={}, device=run.device)
        self.k = 0

    def _call(self, data, warmup, timings, device):
        c = self.config
        settings = None
        if c.get("settings"):
            settings = dataclasses.replace(
                self.mbm.default_settings(c["robot"], c["planner"]), **c["settings"])
        return self.mbm.run_suite(c["robot"], data=data, batch_size=self.n, warmup=warmup,
                                  planner=c["planner"], settings=settings, timings=timings,
                                  device=device)

    def step(self, run) -> dict:
        idx = int(self.order[self.k % self.pool_len])
        self.k += 1
        data, _ = self.suites[idx]
        tm: dict = {}
        t0 = time.perf_counter()
        with run.span("run_suite"):
            res = self._call(data, warmup=False, timings=tm, device=run.device)
        t1 = time.perf_counter()
        solved = np.asarray(res.plan.solved) & res.valid
        return {"t0": t0, "t1": t1, "pool": idx, "problems": len(res.valid),
                "timings": tm, "valid": res.valid, "solved": solved,
                "cost": np.asarray(res.simplified.cost)[solved], "result": res}

    def tally(self, run):
        """(attempted, failed, valid) over the window: every problem, those
        the reference finds valid that the program left unsolved, and those
        it finds valid."""
        ref_valid = [
            check.reference_valid(run.robot, [p["start"] for p in probs],
                                  [p["goals"][0] for p in probs],
                                  ("obstacles", [geometry.obstacles(p) for p in probs]),
                                  run.device)
            for _, probs in self.suites]
        attempted = sum(it["problems"] for it in run.items)
        failed = sum(int((ref_valid[it["pool"]] & ~it["solved"]).sum()) for it in run.items)
        valid = sum(int(ref_valid[it["pool"]].sum()) for it in run.items)
        return attempted, failed, valid

    def decisions(self, run, rng):
        """A sample of the window's answers, drawn from the seed: each
        problem's validity, and every state of its planned and simplified
        paths where it was solved.  Returns (decisions, scene)."""
        answers = [(i, r) for i, it in enumerate(run.items) for r in range(it["problems"])]
        take = int(run.cell.limits["check"]["problems"])
        pick = rng.choice(len(answers), size=min(take, len(answers)), replace=False)
        dec = check.Decisions(run.robot.dimension)
        scenes = []
        for row, a in enumerate(sorted(pick)):
            i, r = answers[a]
            it = run.items[i]
            p = self.suites[it["pool"]][1][r]
            scenes.append(geometry.obstacles(p))
            dec.problems.append(p)
            add_answer(dec, row, p, it["result"], r, it["valid"][r], it["solved"][r],
                       run.robot.resolution)
        return dec, ("obstacles", scenes)


def add_answer(dec, row, problem, res, r, valid, solved, resolution):
    """One suite answer's decisions: the validity verdict, and, where it was
    solved, every state of both paths joined to the problem's endpoints."""
    start, goal = problem["start"], problem["goals"][0]
    dec.add_endpoints(row, start, goal, bool(valid))
    if not solved:
        return
    for part in (res.plan, res.simplified):
        L = int(part.path_length[r])
        path = np.asarray(part.path[r][:L])
        dec.add_path(row, *check.polyline_states(start, goal, path, resolution, meta=True))
        dec.add_cost(path, float(part.cost[r]))
