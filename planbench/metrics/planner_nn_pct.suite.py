"""The planner's two nearest-neighbour scans as a share of its phase
clocks: the runner's count planner_nn_cyc over planner_cyc (rank 0's
clock64 cycles of every planner launch, summed over the problems), summed
over the window's suites; nothing where the runner does not count them."""


def read(run):
    tms = [it["timings"] for it in run.items if "planner_cyc" in it.get("timings", {})]
    whole = sum(t["planner_cyc"] for t in tms)
    return 100.0 * sum(t["planner_nn_cyc"] for t in tms) / whole if whole > 0 else None
