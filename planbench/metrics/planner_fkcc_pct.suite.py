"""The planner's FK + collision pass as a share of its phase clocks: the
runner's count planner_fkcc_cyc over planner_cyc (rank 0's clock64 cycles
of every planner launch, summed over the problems), summed over the
window's suites; nothing where the runner does not count them."""


def read(run):
    tms = [it["timings"] for it in run.items if "planner_cyc" in it.get("timings", {})]
    whole = sum(t["planner_cyc"] for t in tms)
    return 100.0 * sum(t["planner_fkcc_cyc"] for t in tms) / whole if whole > 0 else None
