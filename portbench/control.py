"""The control and the planted faults of a cell, at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, the plain reference is put in the program's place twice:
computed in the control's precision (the workload's ``control``: "fp8"
below the configuration's bf16, "tf32" for float32 with TF32 off), and
with half of each batch left out; each is compared with the float32
reference by the cell's own comparison. Prints one JSON line a seed. A
state left unchanged reads 1 by the comparison's measure and needs no run.
The benchmark's own runs do not run this.
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell, cfg, driver = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = driver.control_readings(cell, cfg, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
