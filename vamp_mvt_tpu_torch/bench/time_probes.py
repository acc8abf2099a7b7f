"""Time the probe kernels of one source tree on the card: the six gather
probes (`csrc/probe_gather.cu`) and the fifteen Mosaic probes
(`csrc/probe_mosaic.cu`).

    python vamp_mvt_tpu_torch/bench/time_probes.py [--tree DIR] [--label NAME]

Imports `vamp_mvt_tpu_torch` from `--tree` (default: the checkout holding
this file), so that an older tree unpacked beside it (`git archive`) can be
timed by the same script; run parent, change, change, parent in one call to
compare two versions on one card.  The inputs (`inputs`, seeds 3 and 4, as
`chip_smoke.py` draws them) and the bounds (`work`) come from this
checkout's `probes/gather.py` and `probes/mosaic.py` whatever the tree, so
every tree is timed on the same tensors against the same bounds.  Each
probe, at TILES (4096) tiles:

  ms                 one call through the wrapper's `launch` between two CUDA
                     events, the median of 20 after 3 warm-ups: the host's
                     work included
  device_ms          the card's time alone: PER_GRAPH calls captured in one
                     CUDA graph, call i on copy i % copies of the inputs and
                     each writing an output of its own, the median of 5
                     replays over PER_GRAPH
  copies, l2         enough copies that, between two calls on one copy, the
                     others touch the card's L2 size in bytes (`work`'s
                     bytes a call): "cold"; where PER_GRAPH copies are too
                     few, "warm" (the time is L2-warm)
  bound_ms, bound_by the larger of `work`'s bytes over 3.35 TB/s and its
                     operations over 67 TFLOP/s (H100 SXM data sheet)
  share              bound_ms / device_ms
  library_ms, library_device_ms
                     the same two times of the one PyTorch call that computes
                     the probe (GATHER_LIBRARY, MOSAIC_LIBRARY; the port never
                     calls them), on the same copies; null where there is
                     none (the reason in `library`)

and `empty_device_ms`, an empty kernel's graph-replayed time (the floor of a
launch; `mosaic.launch_empty`, null for a tree without it).  Prints one JSON
line with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

TILES = 4096
GATHER_SEED, MOSAIC_SEED = 3, 4
PER_GRAPH = 10  # calls in one CUDA graph
L2_BYTES = 50 * 2**20  # H100's L2, where the card does not report its own
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The one PyTorch call that computes each gather probe (table, int64 index,
# int64 second index), or None, and the call's name or why there is none.
GATHER_LIBRARY = {
    "lane": (lambda t, i, i2: t.expand(i.shape[0], 8, 128).gather(2, i), "torch.gather"),
    "row": (lambda t, i, i2: t[0][i], "table[0][idx]"),
    "bits": (None, "a gather, a shift and a mask: three calls, no one call"),
    "two_level": (lambda t, i, i2: t[i, i2], "table[idx, idx2]"),
    "sublane": (lambda t, i, i2: t.expand(i.shape[0], 8, 128).gather(1, i),
                "torch.gather(dim=1)"),
    "timing": (None, "64 gathers of shifted indices summed: no one call"),
}


def mosaic_library(device) -> dict:
    """{probe: (call on the probe's inputs, or None; its name or why there is
    none)}: the one PyTorch call that computes each Mosaic probe (its
    reduction, scan or copy; the constants of smem_int_out's row and of
    smem_writes' closed form 1028 + 2 off made here)."""
    import torch

    three_i = torch.arange(512, dtype=torch.int32, device=device) * 3
    k1028 = torch.full((1,), 2 * 511 + 2 * 3, dtype=torch.int32, device=device)
    return {
        "dot_argmin": (lambda a, b: torch.argmin(torch.bmm(a, b), dim=1),
                       "torch.argmin(torch.bmm(a, b), 1)"),
        "group32_sum": (lambda x: x.view(-1, 8, 4, 32).sum(-1), "sum(-1)"),
        "reduce_while": (lambda x: torch.sum(x, dim=(1, 2)), "torch.sum"),
        "grid_carry": (lambda x: torch.cumsum(x[:, :, 0], dim=1), "torch.cumsum"),
        "cumsum_first": (lambda x: torch.cumsum(x[:, 0], dim=1), "torch.cumsum"),
        "transpose": (lambda x: x[:, 0, :64, None].contiguous(), ".contiguous()"),
        "smem_int_out": (lambda off: torch.add(off[:, None, None], three_i), "torch.add"),
        "while_carry": (None, "a loop whose trip count depends on the data"),
        "dyn_sublane": (None, "a row written at a data-dependent index, then read back"),
        "smem_writes": (lambda off: torch.add(k1028, off, alpha=2), "torch.add"),
        "nested_loops": (None, "a masked row fill and a product"),
        "scratch_diag": (None, "a diagonal scaled, truncated to int and summed"),
        "halton_digits": (None, "eight digit steps of integer division"),
        "static_reads": (None, "two reads scaled and truncated to int"),
        "dyn_rows_while": (None, "a loop over rows up to a data-dependent count"),
    }


def load_local(name: str):
    """This checkout's probes/<name>.py as a module of its own, importing the
    package from wherever sys.path finds it."""
    path = Path(__file__).resolve().parents[1] / "probes" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_time_probes_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(ops: int, n_bytes: int) -> dict:
    """The card's least time for `ops` FP32 operations moving `n_bytes`."""
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"fp32_ops": int(ops), "bytes": int(n_bytes), "ops_bound_ms": ops_ms,
            "bytes_bound_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def l2_bytes() -> int:
    import torch

    return int(getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) or L2_BYTES)


def copies_for(n_bytes: int, per_graph: int = PER_GRAPH) -> tuple[int, bool]:
    """(copies, cold): copies of a call's inputs that a graph of `per_graph`
    calls rotates over, so that between two calls on one copy the others
    touch at least the L2's bytes (cold), or `per_graph` copies where that
    takes more (warm)."""
    need = 1 + -(-l2_bytes() // max(int(n_bytes), 1))
    return min(need, per_graph), need <= per_graph


def rotating_graph_ms(fn, args, per_graph: int = PER_GRAPH, warmup: int = 2,
                      reps: int = 5) -> float:
    """Device milliseconds of one call of `fn`: `per_graph` calls captured in
    one CUDA graph, call i on `args[i % len(args)]`, every output kept until
    the replays end (so no two calls write one buffer), the median of `reps`
    replays over `per_graph`."""
    import torch

    from vamp_mvt_tpu_torch.bench.time_fkcc import time_launch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args[0])
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for i in range(per_graph):
            keep.append(fn(*args[i % len(args)]))
    ms = time_launch(g.replay, warmup, reps)[0] / per_graph
    del keep, g
    return ms


def measure(fn, ins, n_bytes: int, lib=None, lib_ins=None) -> dict:
    """Times of the kernel call fn(*ins) and of the library call lib(*lib_ins)
    (see the module doc), both rotating over the same number of copies."""
    from vamp_mvt_tpu_torch.bench.time_fkcc import time_launch

    copies, cold = copies_for(n_bytes)
    rot = [ins] + [tuple(None if t is None else t.clone() for t in ins)
                   for _ in range(copies - 1)]
    rec = {"ms": time_launch(lambda: fn(*ins))[0],
           "device_ms": rotating_graph_ms(fn, rot),
           "copies": copies, "l2": "cold" if cold else "warm",
           "library_ms": None, "library_device_ms": None}
    del rot
    if lib is not None:
        lrot = [lib_ins] + [tuple(None if t is None else t.clone() for t in lib_ins)
                            for _ in range(copies - 1)]
        rec["library_ms"] = time_launch(lambda: lib(*lib_ins))[0]
        rec["library_device_ms"] = rotating_graph_ms(lib, lrot)
    return rec


def time_gather(gather, local, dev, tiles: int = TILES) -> dict:
    """{probe: record} of the gather probes: `gather` the tree's module (its
    `launch` is timed), `local` this checkout's (inputs and work)."""
    out = {}
    for name in local.PROBES:
        tab, idx, idx2 = local.inputs(name, tiles, seed=GATHER_SEED, device=dev)
        ops, n_bytes = local.work(name, tiles)
        lib, why = GATHER_LIBRARY[name]
        lib_ins = (tab, idx.long(), None if idx2 is None else idx2.long())
        rec = measure(lambda *a, p=name: gather.launch(p, *a), (tab, idx, idx2), n_bytes,
                      lib, lib_ins)
        rec |= {"library": why, **bound(ops, n_bytes)}
        rec["share"] = rec["bound_ms"] / rec["device_ms"]
        rec["ns_per_element"] = rec["ms"] * 1e6 / (tiles * 1024)
        out[name] = rec
    return out


def time_mosaic(mosaic, local, dev, tiles: int = TILES) -> dict:
    """{probe: record} of the Mosaic probes, as `time_gather`."""
    library = mosaic_library(dev)
    out = {}
    for name in local.PROBES:
        ins = local.inputs(name, tiles, seed=MOSAIC_SEED, device=dev)
        ops, n_bytes = local.work(name, ins)
        lib, why = library[name]
        rec = measure(lambda *a, p=name: mosaic.launch(p, *a), ins, n_bytes, lib, ins)
        rec |= {"library": why, **bound(ops, n_bytes)}
        rec["share"] = rec["bound_ms"] / rec["device_ms"]
        out[name] = rec
    return out


def empty_device_ms(mosaic, dev):
    """The graph-replayed time of the tree's empty kernel, or None."""
    launch_empty = getattr(mosaic, "launch_empty", None)
    return None if launch_empty is None else rotating_graph_ms(
        lambda: launch_empty(dev), [()])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from vamp_mvt_tpu_torch.ops.kernels import build
    from vamp_mvt_tpu_torch.probes import gather, mosaic

    if not torch.cuda.is_available():
        raise SystemExit("time_probes needs a CUDA device")
    dev = torch.device("cuda")
    gather.library()
    mosaic.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "tree": args.tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "tiles": TILES, "l2_bytes": l2_bytes(),
           "empty_device_ms": empty_device_ms(mosaic, dev),
           "gather": time_gather(gather, load_local("gather"), dev),
           "mosaic": time_mosaic(mosaic, load_local("mosaic"), dev),
           "ptxas": {n: build.ptxas_lines(n) for n in ("probe_gather", "probe_mosaic")}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
