"""Capture a device trace of the W-walker HMC trajectory and aggregate op time.

Identifies the per-step XLA tail: prints total device time per
op-name bucket so fusion work can target the real top contributors.

Run: python scripts/trace_step.py [--W 8] [--Nt 24] [--stage hmc|sweep|refresh]
"""

import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, ".")

TRACE_DIR = "/tmp/smoqy_trace"


def capture(W, Nt, stage):
    import jax

    from bench import build_sim
    from smoqyelphqmc_tpu.parallel.walkers import (
        init_walker_states,
        shared_precond_refresh,
        walker_sweep,
    )
    from smoqyelphqmc_tpu.updates.hmc import HMCParams, hmc_update

    ctx, state0 = build_sim(Nt=Nt)
    params = HMCParams(Nt=Nt)
    params_noref = params.replace(refresh_precond_at_start=False)
    states = init_walker_states(ctx, state0, W, seed=1)

    if stage == "hmc":
        fn = jax.jit(jax.vmap(lambda s: hmc_update(ctx, s, params_noref)[0].x))
    elif stage == "refresh":
        fn = jax.jit(lambda s: shared_precond_refresh(ctx, s).precond)
    else:
        fn = jax.jit(lambda s: walker_sweep(ctx, s, params)[0].x)

    out = fn(states)
    jax.block_until_ready(out)

    os.system(f"rm -rf {TRACE_DIR}")
    with jax.profiler.trace(TRACE_DIR):
        for _ in range(3):
            out = fn(states)
        jax.block_until_ready(out)


def parse():
    js = glob.glob(f"{TRACE_DIR}/**/*.trace.json.gz", recursive=True)
    assert js, "no trace.json.gz captured"
    with gzip.open(js[0], "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    # device-lane complete events only
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    buckets = defaultdict(float)
    counts = defaultdict(int)
    total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        pname = pid_names.get(e.get("pid"), "")
        if "/device" not in pname.lower():
            continue
        # only XLA op lane (skip step/module summary lanes)
        name = e.get("name", "")
        dur = e.get("dur", 0.0)
        args = e.get("args", {}) or {}
        cat = args.get("l", "") or name
        # bucket: strip trailing numerals / fusion indices
        b = re.sub(r"[.\d]+$", "", name)
        buckets[b] += dur
        counts[b] += 1
        total += dur
    rows = sorted(buckets.items(), key=lambda kv: -kv[1])
    print(f"total device us (3 reps): {total:.0f}")
    print("| op bucket | total ms | count | avg us |")
    print("|---|---|---|---|")
    for name, us in rows[:40]:
        print(f"| {name[:70]} | {us / 1e3:.2f} | {counts[name]} | {us / counts[name]:.1f} |")


if __name__ == "__main__":
    W, Nt, stage = 8, 24, "hmc"
    for i, a in enumerate(sys.argv):
        if a == "--W":
            W = int(sys.argv[i + 1])
        if a == "--Nt":
            Nt = int(sys.argv[i + 1])
        if a == "--stage":
            stage = sys.argv[i + 1]
    capture(W, Nt, stage)
    parse()
