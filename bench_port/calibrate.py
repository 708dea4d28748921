"""Readings that the limits of ``correct`` are set from, many seeds in one
process (on the card, at the cell's own sizes):

    python3 -m bench_port.calibrate --workload <name> --seeds 1 2 3 ... \\
        --control-seeds 4 5 6 --seconds 2

For each of ``--seeds``: the program's worst row distance to the fp32
reference over a short window at the cell's load that covers every pool
image (``program``). For each of ``--control-seeds``: the worst distance of
the reference computed in fp8 (the control, ``siglip_ref.FP8``) to the fp32
one over the same pool (``control``). One JSON line per reading, then a
summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from bench_port.reference import siglip_ref
from bench_port.run import SetupTimer, program_home
from bench_port.spec import Layout, load_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    layout = Layout()
    cell = load_cell(args.workload, layout)
    driver, dev = cell.driver, torch.device("cuda")
    program, control = [], []

    def emit(line: dict) -> None:
        print(json.dumps(line), file=sys.__stdout__, flush=True)

    with program_home(layout.root) as workdir, contextlib.redirect_stdout(sys.stderr):
        state = driver.setup(cell, args.seeds[0], dev, workdir, SetupTimer(time.perf_counter()))
        for seed in args.seeds:
            driver.reseed(state, seed)
            start, calls = time.perf_counter(), 0
            while calls < state.pool_size // state.batch or time.perf_counter() - start < args.seconds:
                driver.call(state, calls)
                calls += 1
            t_ref = time.perf_counter()
            d = driver.row_distances(state, driver.reference(state))
            program.append(float(np.nanmax(d)))
            emit({"kind": "program", "seed": seed, "calls": calls, "rows": int(len(d)),
                  "reference_s": time.perf_counter() - t_ref, "max_row_dist": program[-1],
                  "median_row_dist": float(np.nanmedian(d)), "bad_rows": int((~np.isfinite(d)).sum())})
        for seed in args.control_seeds:
            driver.reseed(state, seed)
            exact = driver.reference(state)
            d = np.linalg.norm(driver.reference(state, siglip_ref.FP8()).astype(np.float64) - exact, axis=1)
            control.append(float(d.max()))
            emit({"kind": "control", "seed": seed, "rows": int(len(d)), "max_row_dist": control[-1],
                  "median_row_dist": float(np.median(d))})
    emit({"kind": "summary", "workload": args.workload, "program_max": max(program),
          "control_min": min(control) if control else None})
    return 0


if __name__ == "__main__":
    sys.exit(main())
