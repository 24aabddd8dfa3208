"""Read the numbers a cell's correctness check compares, on many seeds, for
setting its limits: the program's, its control's and planted faults', one
JSON line a seed (the driver's `readings`).

    python3 h100_bench/tools/readings.py --workload <name> --seeds 1,2,3 [--seconds 3]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from h100_bench.core import manifest as mf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = mf.cell_spec(mf.load_manifest(), args.workload)
    drv = mf.load_driver(spec["traffic"]["driver"], spec["bench"])
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = drv.Cell(spec, seed, dev)
        cell.setup()
        r = drv.readings(cell, args.seconds)
        out = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t}
        for k, v in r.items():
            out[k] = {n: x for n, x, _ in v} if isinstance(v, list) else v
        print(json.dumps(out), flush=True)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
