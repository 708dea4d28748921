"""How much a NaFlex cell's rate depends on its aspect mix (on the card, at
the cell's own sizes):

    python3 -m bench_port.mix_check --workload <name> --seed <n> --seconds 10

One process, one engine, the seed's weights: a window of ``--seconds`` over
the cell's mix, then over each of its families alone (every pool image of
that family's grid), then over the mix again. One JSON line a window: the
rate, the mean real patches an image and the counted operations' share of
the bf16 peak by the host clock.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from bench_port.run import SetupTimer, _measure, program_home
from bench_port.spec import PKG, Layout, load_cell


def windows(cell, seed: int, seconds: float, device: torch.device, root: Path, peak: Optional[float]):
    """Yields one line a window: the cell's mix, each family alone, the mix."""
    sources = cell.traffic.get("naflex_sources")
    if not sources or not cell.config["vision_config"].get("num_patches"):
        raise ValueError(f"{cell.workload['name']} is not a NaFlex cell with an aspect mix")
    driver = cell.driver
    mixes = [("mix", sources)] + [(s["aspect"], [dict(s, share=1.0)]) for s in sources] + [("mix", sources)]
    with program_home(root) as workdir:
        state = driver.setup(cell, seed, device, workdir, SetupTimer(time.perf_counter()))
        for label, mix in mixes:
            state.traffic = dict(cell.traffic, naflex_sources=mix)
            state.pool, state.image_flops = driver.make_pool(state.shape, state.traffic, seed)
            for i in range(2):  # the same batch shape: builds nothing new, evens the clock
                driver.call(state, i)
            state.outputs = []
            _, window, _ = _measure(cell, state, seconds, False)
            rate = window.items / window.seconds
            flops_per_s = driver.window_flops(state, window.calls) / window.seconds
            state.outputs = []
            yield {"traffic": label, "calls": window.calls, "seconds": window.seconds, "index_images_per_s": rate,
                   "mean_real_patches": float(state.pool["masks"].sum(1).mean()),
                   "flops_share_of_peak_pct": 100 * flops_per_s / peak if peak else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    layout = Layout()
    cell = load_cell(args.workload, layout)
    dev = torch.device("cuda")
    peak = json.loads((PKG / "peaks.json").read_text())[torch.cuda.get_device_name(dev)]["bf16_flops_per_s"]
    with contextlib.redirect_stdout(sys.stderr):
        for line in windows(cell, args.seed, args.seconds, dev, layout.root, peak):
            print(json.dumps(line), file=sys.__stdout__, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
