"""Time the gossip jobs of ``chip_smoke.py``'s phase 5 (``gossip_1``,
``gossip_2``, ``int8_gossip``: MAIN_JOB under the decentralized topology,
3 rounds in one chunk) on the card, for two versions of the port in turns.

    python3 tools/gossip_round_s.py --baseline DIR

DIR is the ``src`` directory of another checkout (for instance the parent
commit's, unpacked with ``git archive``). Runs one process per version in
the order baseline, this tree, this tree, baseline; each runs every job
twice (the first pays the process's first use) and prints one JSON line.
Then prints the card's name and power limit and a summary: per job and
version, the warm runs' round_s. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOBS = ("gossip_1", "gossip_2", "int8_gossip")


def one(src: str) -> dict:
    """Every job of JOBS twice through the ``repro_torch`` under ``src``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import torch
    from repro_torch.core.jobs import load_job
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.runtime.executor import Executor
    if not torch.cuda.is_available():
        raise SystemExit("gossip_round_s: no CUDA card")
    import repro_torch
    out = {"src": str(pathlib.Path(repro_torch.__file__).resolve().parent), "jobs": {}}
    for name in JOBS:
        runs = []
        for _ in range(2):
            r, ex = cs.run_slice5(torch, qa, load_job, Executor, name, cs.slice5_job(name))
            runs.append({"round_s": r["round_s"], "losses": r["losses"]})
            del ex
        out["jobs"][name] = runs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="the other version's src directory")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    if not args.baseline:
        ap.error("--baseline DIR is required")
    here = str(ROOT / "src")
    order = [("baseline", args.baseline), ("change", here), ("change", here),
             ("baseline", args.baseline)]
    warm = {}
    for label, src in order:
        res = subprocess.run([sys.executable, __file__, "--one", src], check=True,
                             stdout=subprocess.PIPE, text=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"version": label, **line}), flush=True)
        for name, runs in line["jobs"].items():
            warm.setdefault(name, {}).setdefault(label, []).append(runs[1]["round_s"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print(json.dumps({"warm_round_s": warm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
