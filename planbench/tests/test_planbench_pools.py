"""The existing cells' pools are pinned: every scene object, start and goal
that the generator draws for them hashes to a digest frozen from the
generator as it was before a configuration could place its own scenes (the
Panda box, written into the generator).

Each traffic file's own pool is drawn whole, at its `pool_seed`, so its
digest does not depend on the run's seed.  A pool drawn from the run's seed
instead (the traffic's `pool_seed` left out) is pinned on three seeds, cut
to 2 items of 12 problems for CPU time."""

import hashlib
import json

import pytest

from planbench import generator, harness
from planbench.reference import robot as ref_robot

FIXED = {
    "panda_prim_suite": "11abae0fb3464be58fc3a0f837cda539b6a333e9f2ee49c2db3c4dda29664ccf",
    "panda_cloud_query": "ea8418b5a3ac116e949bd959acc7dab79d3ecea1beca75d84474d8331234e3b1",
}
SEEDED = {
    ("panda_prim_suite", 0):
        "39ef2551c0f49f8f4ac77bccc3c3ad264a35e35edd1e9b82dd95a0d6988376a8",
    ("panda_prim_suite", 2**31 + 5):
        "68a2ddd23b51cd11abff2cacd6c4b085ee9075202a7259af65fb9d4c3f0e5758",
    ("panda_prim_suite", 2**33 + 17):
        "2b7a75ab05fe9640b5c0abfca0249589716e0eb9654bbcab0cfc277ea1fa9b7f",
    ("panda_cloud_query", 0):
        "9a95a470609363f77e6d1871ec6619443f1cb979b681e48562c46bc189fc7bb0",
    ("panda_cloud_query", 2**31 + 5):
        "5a34d1b3e68feac9a3493ec83ef1d622e5c7b62193dc0ee399af550813799754",
    ("panda_cloud_query", 2**33 + 17):
        "99a9479c327c1417f81ddcb5941752925f3bb63f01c11a0a6ea92c52cc82b3dc",
}


def _digest(pool) -> str:
    """sha256 of every problem of every item: scenario, index, each object's
    numbers, start and goal (floats as their exact repr)."""
    return hashlib.sha256(json.dumps(pool, sort_keys=True).encode()).hexdigest()


def _pool(name: str, seed: int, traffic=None):
    cell = harness.Cell(name)
    robot = ref_robot.load(cell.config["robot"])
    return generator.pool(robot, traffic or cell.traffic, cell.config, seed, "cpu")


@pytest.mark.parametrize("name", sorted(FIXED))
def test_fixed_pool_matches_its_digest(name):
    assert _digest(_pool(name, 2**31 + 1)) == FIXED[name]


@pytest.mark.parametrize("name,seed", sorted(SEEDED))
def test_seeded_pool_matches_its_digest(name, seed):
    traffic = {k: v for k, v in harness.Cell(name).traffic.items() if k != "pool_seed"}
    traffic.update(problems=12, pool=2)
    assert _digest(_pool(name, seed, traffic)) == SEEDED[name, seed]
