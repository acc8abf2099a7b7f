"""How full the card was while the planner kernel ran: its blocks' time
over the card's block slots for the launches' spans (the runner's counts
planner_block_ns and planner_slot_ns, from the kernel's %globaltimer),
summed over the window; nothing where the runner does not count them."""


def read(run):
    tms = [it["timings"] for it in run.items if "planner_slot_ns" in it.get("timings", {})]
    slot = sum(t["planner_slot_ns"] for t in tms)
    return 100.0 * sum(t["planner_block_ns"] for t in tms) / slot if slot > 0 else None
