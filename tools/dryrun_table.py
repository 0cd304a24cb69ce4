"""Tables of the dry run (``repro_torch.launch.dryrun``) for ``PERF.md``.

    python3 tools/dryrun_table.py [--tag grid]          # the grid's records
    python3 tools/dryrun_table.py --jax                 # port against JAX, 4 reduced cells

Without ``--jax``: one row per (arch, shape) of the records under
``results/dryrun_torch/`` that carry ``--tag`` (written by ``python -m
repro_torch.launch.dryrun --both-meshes --tag grid``), the two production
meshes side by side: per-rank inputs and peak (GB), whether the peak fits
an H100 80GB HBM3's memory, FLOPs, collective traffic (GB) and collective
counts by kind. A missing cell is marked as such.

With ``--jax``: the reduced cells of ``tests/test_torch_dryrun.py`` on a
(2, 2) mesh, the JAX package's compile (that test file run as a script,
in a subprocess on 8 forced host devices: it needs JAX; this tool imports
none) beside the port's meta dry run of each rank: argument bytes, FLOPs
(the port's against JAX's with the test's named terms) and collective
counts by kind.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results" / "dryrun_torch"
HBM_BYTES = 85_017_493_504        # an H100 80GB HBM3's total_memory, as torch reports it
KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def _counts(rec) -> str:
    return " ".join(f"{KINDS[k]} {v}" for k, v in rec["collectives"]["counts"].items() if v) \
        or "none"


def grid_table(tag: str) -> str:
    """The grid's table, markdown."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ARCHS, shapes_for
    rows = ["| arch | shape | L | args GB 16x16 / 2x16x16 | peak GB | fits 80 GB | FLOPs | "
            "coll. traffic GB | coll. counts 16x16; 2x16x16 |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in shapes_for(arch):
            recs = []
            for mesh in ("sp", "mp"):
                f = RESULTS / f"{arch}__{shape}__{mesh}__{tag}.json"
                recs.append(json.loads(f.read_text()) if f.exists() else None)
            if None in recs:
                rows.append(f"| {arch} | {shape} | | missing: "
                            f"{' '.join(m for m, r in zip(('16x16', '2x16x16'), recs) if r is None)}"
                            " | | | | | |")
                continue

            def both(fn):
                return " / ".join(fn(r) for r in recs)
            gb = 2**30 / 1e9
            rows.append(
                f"| {arch} | {shape} | {recs[0]['layers']} | "
                f"{both(lambda r: f'{r['memory']['args_GiB'] * gb:.2f}')} | "
                f"{both(lambda r: f'{r['memory']['peak_GiB'] * gb:.2f}')} | "
                f"{both(lambda r: 'yes' if r['memory']['peak_GiB'] * 2**30 <= HBM_BYTES else 'NO')} | "
                f"{both(lambda r: f'{r['cost']['flops']:.3e}')} | "
                f"{both(lambda r: f'{sum(r['collectives']['traffic_bytes'].values()) / 1e9:.2f}')} | "
                f"{'; '.join(_counts(r) for r in recs)} |")
    return "\n".join(rows)


def jax_table() -> str:
    """The reduced cells, port against JAX, markdown."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_dryrun as t
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_mod
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jax.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        subprocess.run([sys.executable, str(ROOT / "tests" / "test_torch_dryrun.py"), out],
                       env=env, check=True, capture_output=True, text=True, timeout=600)
        jax = json.loads(pathlib.Path(out).read_text())
    rows = ["| reduced cell, (2, 2) | JAX `argument_size_in_bytes` | port per-rank inputs | "
            "JAX `hlo_cost` FLOPs | port FLOPs, ranks 0 / 1 | JAX + C10 loss − masked pairs, "
            "ranks 0 / 1 | JAX collectives | port collectives, each rank |",
            "|---|---|---|---|---|---|---|---|"]
    sizes = {"data": 2, "model": 2}
    try:
        for arch, kind in t.JAX_CELLS:
            recs = []
            for rank in (0, 1):     # ranks 2 and 3 repeat them (model index 0, 1)
                mesh_mod.fake_world(4, rank, "meta")
                mesh = mesh_mod.make_test_mesh((2, 2), device="meta")
                built = steps.make_step_from_cfg(t._cfg(arch), t._shape(kind), mesh)
                recs.append(dryrun.measure(built, t._shape(kind))[0])
            j = jax[f"{arch}/{kind}"]
            cfg, shape = t._cfg(arch), t._shape(kind)
            want = [j["flops"] + t.c10_loss_flops(cfg, shape, sizes, kind)
                    - t.masked_attention_flops(cfg, shape, sizes, r, kind) for r in (0, 1)]
            jc = " ".join(f"{KINDS[k]} {v}" for k, v in j["coll"].items())
            rows.append(
                f"| {arch} {kind} | {j['args']:,} | {round(recs[0]['memory']['args_GiB'] * 2**30):,} | "
                f"{j['flops']:.4e} | {recs[0]['cost']['flops']:.4e} / {recs[1]['cost']['flops']:.4e} | "
                f"{want[0]:.4e} / {want[1]:.4e} | {jc} | {_counts(recs[0])} |")
    finally:
        mesh_mod.end_world()
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="grid")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args(argv)
    print(jax_table() if args.jax else grid_table(args.tag))


if __name__ == "__main__":
    main()
