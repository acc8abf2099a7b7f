"""What the one-problem-a-request drivers share: the pool, its order, the
tally and the sample the reference checks.

A closed loop of one client: each request is one problem of the pool, in
an order drawn from the seed; the window runs whole passes over the pool,
so that every seed's window holds the same work.  A request that raises a
ValueError (the runner's refusals) counts as unsolved.
"""

from __future__ import annotations

import time

import numpy as np

from planbench import generator, harness
from planbench.reference import check


class QueryDriver:
    def __init__(self, run):
        self.traffic, self.config = run.cell.traffic, run.cell.config

    def setup(self, run):
        self.problems = generator.pool(run.robot, self.traffic, self.config, run.seed,
                                       run.device)[0]
        self.pool_len = len(self.problems)
        self.order = np.random.default_rng(
            generator.seed_seq(run.seed, 3)).permutation(self.pool_len)
        self.k = 0
        harness.fresh_peak(run.device)
        self.prepare(run)
        # warm-up: one request of the cell's own shape, whose goal is its
        # start, which the planner ends at once
        self.ask(run, dict(self.problems[0], goals=[self.problems[0]["start"]]))

    def step(self, run) -> dict:
        idx = int(self.order[self.k % self.pool_len])
        self.k += 1
        t0 = time.perf_counter()
        try:
            item = self.ask(run, self.problems[idx])
        except ValueError as e:
            item = {"error": str(e), "solved": False, "valid": False}
        item.update(t0=t0, t1=time.perf_counter(), pool=idx)
        return item

    def tally(self, run):
        """(attempted, failed, valid) over the window: every request, those
        whose problem the reference finds valid that the program left
        unsolved (or that raised), and those it finds valid."""
        ref_valid = check.reference_valid(
            run.robot, [p["start"] for p in self.problems],
            [p["goals"][0] for p in self.problems],
            self.scene_kind([self.scene(p) for p in self.problems]), run.device)
        valid = [bool(ref_valid[it["pool"]]) for it in run.items]
        failed = sum(1 for it, ok in zip(run.items, valid) if ok and not it["solved"])
        return len(run.items), failed, sum(valid)

    def decisions(self, run, rng):
        """The window's answers to `check.requests` distinct problems drawn
        from the seed (a problem answered twice is answered alike; its
        first answer is checked), every one where that is fewer."""
        first: dict = {}
        for it in run.items:
            if "error" not in it:
                first.setdefault(it["pool"], it)
        keys = sorted(first)
        take = int(run.cell.limits["check"]["requests"])
        pick = sorted(rng.choice(len(keys), size=min(take, len(keys)), replace=False))
        dec = check.Decisions(run.robot.dimension)
        scenes = []
        for row, k in enumerate(pick):
            it = first[keys[k]]
            p = self.problems[keys[k]]
            scenes.append(self.scene(p))
            dec.problems.append(p)
            start, goal = p["start"], p["goals"][0]
            if "valid" in it:
                dec.add_endpoints(row, start, goal, bool(it["valid"]))
            if it["solved"]:
                for path, cost in zip(it["paths"], it["costs"]):
                    dec.add_path(row, *check.polyline_states(start, goal, path,
                                                             run.robot.resolution, meta=True))
                    dec.add_cost(path, cost)
        return dec, self.scene_kind(scenes)
