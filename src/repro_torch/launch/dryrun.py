"""Dry run of every (arch x shape x production mesh) cell, one rank at a
time (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all] [--shape all]
        [--multi-pod | --both-meshes] [--layers K] [--rank R] [--device meta|cuda]
        [--hbm-gib G] [--tag T]

The JAX package forces 512 host devices, then lowers and compiles each
cell's SPMD step on the 16x16 or 2x16x16 mesh, and reads the compiled
program: its memory analysis, its cost analysis and the collectives in its
HLO. The port runs a mesh as one process a rank (``launch/mesh.py``), so
here one process stands for one rank of the 256- or 512-rank mesh, the
others a fake process group (``mesh.fake_world``) whose collectives move no
bytes, and it runs that rank's step (``launch/steps``) on the rank's
shards (``BuiltStep.empty``):

- on the **meta device** (the default): shapes and no values, no card. The
  counterpart of the JAX compile. Memory is every storage the step holds,
  from its inputs to its outputs, tracked live and rounded as the CUDA
  caching allocator rounds a block (``LiveBytes``); the costs are
  ``launch/op_cost``'s, counted as the step runs;
- on **the card** (``--device cuda``): the rank's step really runs its
  kernels at the rank's production shapes, once counted under
  ``op_cost.cost_scope`` (which also warms it up), then once timed and
  measured without a scope (``torch.cuda.max_memory_allocated`` after a
  reset), beside the meta run of the same rank, its prediction. The time
  is compute only: the fake group moves no bytes. A fake collective leaves
  its output as it found it, so the values mean nothing.

Every number is the rank's. ``--layers k`` cuts the stack to k layers (an
encoder-decoder's encoder too; a hybrid's or xLSTM's to whole periods, at
least k layers). A cell a port check refuses (``steps.check_divisible``,
``moe.check_mesh``) is a failure, named with its error.

One JSON file a cell under ``results/dryrun_torch/``; the record has the JAX
package's keys (``lower_s``/``compile_s`` become ``build_s``/``run_s``)
plus ``rank``, ``device``, ``kernels`` (``op_cost.Cost.by_kernel``) and
``fits`` (the peak against ``--hbm-gib``, or the card's memory).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import weakref

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_cost
from repro_torch.launch import steps as steps_mod

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
HBM_GIB = 85_017_493_504 / 2**30   # an H100 80GB HBM3's total_memory, as torch reports it
ALLOC_ROUND = 512        # the CUDA caching allocator's block granularity, bytes
_TORCH_DIR = str(pathlib.Path(torch.__file__).resolve().parent)
# ops the autograd engine runs in place without a dispatch mode and out of
# place under one (``LiveBytes``)
IN_PLACE_WITHOUT_MODE = frozenset({"add", "scatter_add", "scatter", "index_put", "index_add",
                                   "slice_scatter", "select_scatter", "masked_scatter"})


def _block(nbytes: int) -> int:
    return 0 if nbytes == 0 else ALLOC_ROUND * math.ceil(nbytes / ALLOC_ROUND)


def _is_cost_counter_dispatch(frame) -> bool:
    return frame.f_code.co_name == "__torch_dispatch__" and \
        isinstance(frame.f_locals.get("self"), op_cost._OpCounter)


def _issued_by_autograd_engine() -> bool:
    """Whether the op being dispatched comes from the autograd engine
    itself (a gradient accumulation, a built-in derivative), not from a
    Python function: the Python frames between the dispatch and the
    engine's entry are all PyTorch's own or ``op_cost``'s counter's
    dispatch (it runs above ``LiveBytes`` in ``measure``)."""
    f = sys._getframe(2)
    while f is not None and (f.f_code.co_filename.startswith(_TORCH_DIR) or
                             _is_cost_counter_dispatch(f)):
        if f.f_code.co_name == "_engine_run_backward":
            return True
        f = f.f_back
    return False


class LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The bytes of every storage on ``device`` that is alive, of the
    tensors ``track``ed and of every op's results while the mode is on, each
    rounded up to the caching allocator's 512-byte block; ``peak`` their
    most. A storage counts from its first sight to its death (a finalizer
    on it), however many tensors view it.

    One correction makes it the peak of a run without any dispatch mode.
    Under a Python mode the autograd engine writes out of place where it
    would write in place without one: it sums two gradients of a tensor
    into a new one (a tensor that has passed through the mode is held by
    its Python object too, so it is never the sole owner), and derivative
    formulas take their out-of-place forms for tensor subclasses and modes
    (``gather``'s backward: ``scatter_add``, not ``scatter_add_`` into
    zeros). So an engine-issued op of ``IN_PLACE_WITHOUT_MODE`` one of
    whose operands of its result's shape dies before the next op counts as
    done in place: its result takes the dying operand's place, with no
    moment when both are alive."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device).type
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}
        self._pending = None

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (live before the mode); returns the
        bytes newly counted."""
        before = self.live
        for t in tree_leaves(tree):
            self._see(t)
        return self.live - before

    def _see(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        self._sizes[key] = n = _block(st.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def _settle(self):
        """The pending engine sum: out of place (its moment of both alive
        counts) unless an operand has died since."""
        if self._pending is not None:
            live, operands = self._pending
            self._pending = None
            if all(k in self._sizes for k in operands):
                self.peak = max(self.peak, live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._settle()
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in IN_PLACE_WITHOUT_MODE and \
                _issued_by_autograd_engine():
            peak = self.peak
            self.track(out)
            self.peak = peak
            self._pending = (self.live, [id(a.untyped_storage()) for a in args[:2]
                                         if isinstance(a, torch.Tensor) and
                                         a.shape == out.shape and a.dtype == out.dtype])
        else:
            self.track(out)
        return out

    def __exit__(self, *exc):
        self._settle()
        return super().__exit__(*exc)


def truncated(cfg, layers):
    """``cfg`` with its stack cut to ``layers`` (None: as it is): an
    encoder-decoder's encoder too, a hybrid's or xLSTM's to the fewest whole
    periods that hold ``layers``."""
    if not layers:
        return cfg
    period = (cfg.hybrid.period if cfg.family == "hybrid" else
              cfg.ssm.slstm_every if cfg.family == "ssm" else 1)
    kw = {"n_layers": period * math.ceil(layers / period)}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = layers
    return cfg.replace(**kw)


def _nbytes(tree) -> int:
    """Bytes of the tensors of ``tree``, each storage once."""
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in seen:
            seen.add(id(t.untyped_storage()))
            n += t.untyped_storage().nbytes()
    return n


def _input_bytes(built) -> int:
    """The rank's input bytes: every input's shard."""
    return sum(math.prod(built.local_shape(sp)) * sp.dtype.itemsize
               for sp in steps_mod._leaves(built.inputs))


def _kernel_fns() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, quant_aggregate, rmsnorm
    return {"quant_aggregate": quant_aggregate.quant_aggregate, "rmsnorm": rmsnorm.rmsnorm,
            "flash_attention": flash_attention.flash_attention_fwd,
            "decode_attention": decode_attention.decode_attention_fwd}


def _launches_by_shape() -> dict:
    """The kernel wrappers' launch counts by shape (the card's), keyed as
    ``op_cost`` keys them."""
    return {name: {",".join(str(int(k)) for k in key): n
                   for key, n in fn.launches_by_shape.items()}
            for name, fn in _kernel_fns().items() if fn.launches_by_shape}


def _zero_launches() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.launches_by_shape.clear()
        for counts in (getattr(fn, "launches_by_layout", {}),
                       getattr(fn, "launches_by_kernel", {})):
            counts.update(dict.fromkeys(counts, 0))


def rank_inputs(built, shape, device):
    """The rank's inputs on ``device``; a decode's lengths at the last slot
    of the cache (the card's kernels then read all of it)."""
    inputs = built.empty(device)
    if shape.kind == "decode":
        inputs[3].fill_(shape.seq_len - 1)
    return inputs


def measure(built, shape, device: str = "meta", hbm_gib: float = HBM_GIB):
    """Run ``built``, one rank's step of ``shape``, on ``device`` ("meta"
    or "cuda"; the world already up) -> (the record's measured part, the
    ``op_cost.Cost`` of its counted run)."""
    inputs = rank_inputs(built, shape, device)
    args = _input_bytes(built)
    rec = {}
    if device == "meta":
        with LiveBytes(device) as mem, op_cost.cost_scope() as cost:
            mem.track(inputs)
            t0 = time.perf_counter()
            out = built.fn(*inputs)
            rec["run_s"] = time.perf_counter() - t0
        peak, out_bytes = mem.peak, _nbytes(out)
        hbm = hbm_gib * 2**30
    else:
        with op_cost.cost_scope() as cost:      # counted; warms the step up too
            out = built.fn(*inputs)
            torch.cuda.synchronize()
        del out
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = built.fn(*inputs)
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        peak, out_bytes = torch.cuda.max_memory_allocated(), _nbytes(out)
        rec["launches_by_shape"] = _launches_by_shape()
        hbm = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    del out
    rec["memory"] = {"args_GiB": args / 2**30, "output_GiB": out_bytes / 2**30,
                     "temp_GiB": (peak - args) / 2**30, "peak_GiB": peak / 2**30}
    rec["fits"] = bool(peak <= hbm)
    rec["hbm_GiB"] = hbm / 2**30
    rec["cost"] = {"flops": cost.flops, "bytes_accessed": cost.hbm_bytes}
    rec["collectives"] = {"traffic_bytes": dict(cost.coll_traffic),
                          "result_bytes": dict(cost.coll_result_bytes),
                          "counts": dict(cost.coll_counts)}
    rec["kernels"] = cost.by_kernel
    return rec, cost


def _run(cfg, shape, multi_pod: bool, rank: int, device: str, hbm_gib: float) -> dict:
    """Build and measure the rank's step in a fake world of the mesh's
    ranks, torn down after."""
    mesh_mod.fake_world(512 if multi_pod else 256, rank, device)
    try:
        t0 = time.perf_counter()
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device=device)
        built = steps_mod.make_step_from_cfg(cfg, shape, mesh)
        build_s = time.perf_counter() - t0
        return {"build_s": build_s, **measure(built, shape, device, hbm_gib)[0]}
    finally:
        mesh_mod.end_world()


def run_cell(arch: str, shape_name: str, multi_pod: bool, layers: int | None = None, *,
             rank: int = 0, device: str = "meta", hbm_gib: float = HBM_GIB,
             verbose: bool = True) -> dict:
    """One cell as rank ``rank`` of the production mesh, on ``device``
    ("meta" or "cuda") -> its record (the module docstring). On the card
    the record also holds, under ``meta``, the meta run of the same rank:
    its prediction."""
    cfg = truncated(get_config(arch), layers)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind, "layers": cfg.n_layers, "rank": rank, "device": device}
    if device != "meta":
        rec["meta"] = _run(cfg, shape, multi_pod, rank, "meta", hbm_gib)
    rec.update(_run(cfg, shape, multi_pod, rank, device, hbm_gib))
    if verbose:
        counts = {k: v for k, v in rec["collectives"]["counts"].items() if v}
        print(f"[{arch} x {shape_name} x {rec['mesh']} L={rec['layers']}] "
              f"run {rec['run_s']:.1f}s  args {rec['memory']['args_GiB']:.2f}G "
              f"temp {rec['memory']['temp_GiB']:.2f}G  peak {rec['memory']['peak_GiB']:.2f}G "
              f"fits={rec['fits']}  flops {rec['cost']['flops']:.3e}  coll {counts}",
              flush=True)
    return rec


def main(argv=None) -> list:
    """Run the requested cells; returns their records. Exits 1, naming
    each, when a cell fails."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="truncate layer stacks (whole periods for hybrid and xLSTM)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0, help="the rank this process stands for")
    ap.add_argument("--device", choices=("meta", "cuda"), default="meta")
    ap.add_argument("--hbm-gib", type=float, default=HBM_GIB,
                    help="device memory a meta run's peak must fit (cuda: the card's)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from repro_torch.runtime.device import resolve_device
        resolve_device("cuda")
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    RESULTS.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records, failures = [], []
    for arch in archs:
        names = shapes_for(arch) if args.shape == "all" else args.shape.split(",")
        for shape_name in names:
            if shape_name not in shapes_for(arch):
                continue
            for mp in meshes:
                key = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                key += f"__L{args.layers}" if args.layers else ""
                key += f"__r{args.rank}" if args.rank else ""
                key += "__cuda" if args.device == "cuda" else ""
                key += f"__{args.tag}" if args.tag else ""
                try:
                    rec = run_cell(arch, shape_name, mp, args.layers or None, rank=args.rank,
                                   device=args.device, hbm_gib=args.hbm_gib)
                except Exception as e:  # noqa: BLE001 -- a cell's failure is reported, the grid goes on
                    failures.append((key, repr(e)[:400]))
                    print(f"FAIL {key}: {e!r}", flush=True)
                    continue
                (RESULTS / f"{key}.json").write_text(json.dumps(rec, indent=1))
                records.append(rec)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for k, e in failures:
            print(" ", k, e)
        sys.exit(1)
    print("\nAll requested dry-run cells ran.")
    return records


if __name__ == "__main__":
    main()
