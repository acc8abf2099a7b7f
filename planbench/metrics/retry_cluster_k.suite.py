"""Blocks a problem in the suite's retry launches: the runner's count
retry_blocks (each retry launch's rows x its thread-block cluster size)
over its count retry_live (the rows those launches plan), summed over the
window's suites, so a suite of several batches weighs each launch by its
rows; nothing where the runner does not count retry_blocks."""


def read(run):
    tms = [it["timings"] for it in run.items if "retry_blocks" in it.get("timings", {})]
    rows = sum(t["retry_live"] for t in tms)
    return sum(t["retry_blocks"] for t in tms) / rows if rows else None
