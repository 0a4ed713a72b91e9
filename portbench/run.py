"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload rig-occl.solve --seed 7 \\
        --seconds 10 --trace 0

The cell (``BENCHMARK.json``'s ``workloads`` entry and
``portbench/cells/<name>.json``) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and an
entry (``entries/<name>.py``), each found by name. A run makes the scene
from ``--seed`` on the card, lets the entry build the program's layout and
make one warm-up call (set-up), then makes whole calls back to back from
the same start until ``--seconds`` have passed (the window), checks that no
JAX module was loaded, frees the program's state and judges every answer
of the window against the plain reference. ``--trace 1`` adds the entry's
probes and a profiled sub-window of whole calls, and reports the
per-layer metrics (``metrics/<name>.py``) instead of the end-to-end ones.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "deeparc_tpu")
# one host thread for every numerical library. The program's host work
# (band prep, layout builds, the filter) otherwise runs on pools of
# threads that spin on cores other machines share: on the H100 host a rig
# solve then burns ~1.3 s of CPU for 0.44 s of wall and its runs spread
# 12.6% by the driver's measure, against 5.2% on one thread
THREAD_VARIABLES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS")
# the profiled sub-window: whole calls, at least this long
PROFILE_SECONDS = 1.0


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``deeparc_tpu_torch`` is not ``deeparc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


class Card:
    """Synchronisation and memory readings of the run's device (the CPU
    only in the tests, which have no card)."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()


def judge_answers(entry, calls, ref, ctx, limits) -> tuple:
    """(worst gaps, answers failing a limit): each distinct answer of the
    window judged against the reference; equal answers once."""
    import numpy as np

    def same(a, b):
        return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                   for k in a)

    distinct = []
    for c in calls:
        for d in distinct:
            if same(c["answer"], d[0]):
                d[1] += 1
                break
        else:
            distinct.append([c["answer"], 1])
    worst, failed = {}, 0
    for ans, count in distinct:
        gaps = entry.gaps(ans, ref, ctx)
        missing = set(gaps) - set(limits)
        if missing:
            raise KeyError(f"no limit for {sorted(missing)} in the cell")
        if any(not gaps[k] <= limits[k] for k in gaps):
            failed += count
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, failed


def load_cell(workload: str, overrides: dict | None = None) -> tuple:
    """(BENCHMARK.json, its workload entry, the cell, its configuration,
    its traffic), ``overrides`` merged over the two files."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json("cells", workload)
    if (cell["config"], cell["traffic"]) != (wl["config"], wl["traffic"]):
        raise ValueError(f"cells/{workload}.json names another "
                         "configuration or traffic than BENCHMARK.json")
    cfg = dict(load_json("configs", wl["config"]),
               **(overrides or {}).get("config", {}))
    traffic = dict(load_json("traffic", wl["traffic"]),
                   **(overrides or {}).get("traffic", {}))
    return bench, wl, cell, cfg, traffic


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``device="cpu"`` and ``overrides`` ({"config": {...}, "traffic":
    {...}}, merged over the files) are for the tests' tiny cells."""
    import torch

    from portbench import generate, roofline
    from portbench import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    bench, wl, cell, cfg, traffic = load_cell(workload, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = Card(dev)
    entry = load_module("entries", cell["entry"])
    if traffic["requests"] != entry.UNIT:
        raise ValueError(f"traffic {wl['traffic']!r} requests "
                         f"{traffic['requests']}s, entry {cell['entry']!r} "
                         f"makes {entry.UNIT}s")
    from portbench import answers

    data = generate.make(cfg, traffic, seed, dev)
    ctx = {"config": cfg, "traffic": traffic, "cell": cell, "data": data,
           "device": dev, "seed": seed, "start": answers.start_of(
               data, cfg.get("free_intrinsics", ()))}
    state = entry.setup(ctx)
    entry.call(state)
    card.sync()
    setup_peak = card.peak()
    setup_s = time.perf_counter() - t_start

    card.reset_peak()
    calls = []
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        rec = entry.call(state)
        rec["wall"] = time.perf_counter() - c0
        calls.append(rec)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    window_peak = card.peak()
    found = forbidden_modules()
    if found:
        raise ImportError(f"JAX modules loaded: {found}")

    rec = {"unit": entry.UNIT, "window_s": window_s, "setup_s": setup_s,
           "calls": [{k: v for k, v in c.items() if k != "answer"}
                     for c in calls],
           "peak_bytes": window_peak, "probe": None, "profile": None,
           "work": None}
    if trace:
        rec["probe"] = entry.probe(state, ctx)
        if card.cuda:
            rec["profile"] = tr.profile_calls(entry.call, state,
                                              PROFILE_SECONDS)
        st = ctx["start"]
        rec["work"] = roofline.pass_work(data, st["ext_free_rows"],
                                         st["intr_free"])
    del state
    gc.collect()
    if card.cuda:
        torch.cuda.empty_cache()

    r0 = time.perf_counter()
    ref = entry.reference(ctx, torch.float64)
    gaps, failed = judge_answers(entry, calls, ref, ctx, cell["limits"])
    reference_s = time.perf_counter() - r0
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not applies(m, workload):
            continue
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": failed == 0 and len(calls) > 0,
           "attempted": len(calls), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if card.cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if card.cuda
                               else "cpu"),
                      "count": wl["chips"],
                      "memory_peak_bytes": max(setup_peak, window_peak),
                      "power_limit": power_limit() if card.cuda else None}}
    if trace and rec["profile"] is not None:
        out["device"]["busy_s"] = rec["profile"]["busy_s"]
        out["device"]["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                            "idle_gaps": rec["profile"]["idle_gaps"]}
    out["reference_s"] = reference_s
    out["per_call"] = {k: sorted({c[k] for c in rec["calls"]})
                       for k in ("iterations", "cg_iterations")}
    out["checks"] = {k: {"value": v, "limit": cell["limits"][k]}
                     for k, v in gaps.items()}
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--scene-seed", type=int, default=None,
                   help="draw the scene of a configuration that fixes its "
                   "scene_seed from this one instead (a correctness study "
                   "over scenes; the benchmark's runs never pass it)")
    args = p.parse_args(argv)
    for name in THREAD_VARIABLES:
        os.environ[name] = "1"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = next((w["chips"] for w in json.load(f)["workloads"]
                      if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    overrides = (None if args.scene_seed is None else
                 {"config": {"scene_seed": args.scene_seed}})
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   overrides=overrides, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
