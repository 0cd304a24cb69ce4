"""The paper's main path as a researcher runs it: a job with a ``sweep:``
section through ``repro_torch.core.jobs.load_job`` ->
``repro_torch.runtime.campaign.CampaignExecutor``, S trajectories advanced
as one vmapped program, chunks of ``rounds_per_launch`` rounds back to
back.

The benchmark makes each trajectory seed's data (``traffic.vision``, split
by ``traffic.dirichlet_parts``) and initial weights from ``--seed``, and
hands them to the program: the data through the campaign's dataset factory
(the one seam where a job's dataset is made), the weights written over the
scaffolded state. The sweep's trajectory seeds are drawn from ``--seed``
too. Set-up drives the executor through its first rounds (a chunk of one,
then up to ``ref_rounds``, then ``setup_chunks`` whole chunks); a window
step is one more chunk. ``check`` frees the program, follows each lane's
first ``ref_rounds`` rounds with the plain reference
(``reference/cnn.py``) and compares the lanes' first-round losses, every
leaf's first-round change and its change after ``ref_rounds`` rounds.
"""
from __future__ import annotations

import contextlib
import gc
import math

import torch

from portbench import traffic
from portbench.reference import cnn as ref_cnn
from portbench.yardstick import compare, flops


def leaf_shapes(cfg: dict) -> dict:
    """The CNN's weights: HWIO kernels, (in, out) dense weights."""
    k, (h, w, cin) = cfg["kernel"], cfg["input"]
    out, shapes = {}, {}
    for i, cout in enumerate(cfg["conv_channels"], 1):
        shapes[f"c{i}"], shapes[f"b{i}"] = (k, k, cin, cout), (cout,)
        cin, h, w = cout, h // cfg["pool"], w // cfg["pool"]
    shapes["fc"], shapes["fb"] = (h * w * cin, cfg["fc"]), (cfg["fc"],)
    shapes["out"], shapes["ob"] = (cfg["fc"], cfg["classes"]), (cfg["classes"],)
    out.update(shapes)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Weights uniform in +-1 / sqrt(fan_in) (fan-in: every dim but the
    last; PyTorch's default for ``nn.Conv2d`` and ``nn.Linear``), biases 0."""
    g = traffic.generator(seed, device, "weights")
    out = {}
    for k, s in leaf_shapes(cfg).items():
        if len(s) == 1:
            out[k] = torch.zeros(s, device=device)
        else:
            bound = 1.0 / math.sqrt(math.prod(s[:-1]))
            out[k] = torch.rand(s, generator=g, device=device).mul_(2 * bound).sub_(bound)
    return out


def lane_inputs(cell: dict, seed: int, fl_seed: int, device):
    """(x, y) on the device and the clients' parts of one trajectory seed."""
    t, lane = cell["traffic"], traffic.derive(seed, "lane", fl_seed)
    x, y = traffic.vision(t["data"], lane, device)
    parts = traffic.dirichlet_parts(y.cpu().numpy(), t["partition"], lane)
    return x, y, parts


class _Dataset:
    """What the campaign's dataset factory hands back: the benchmark's
    root set and partition for one trajectory seed."""

    def __init__(self, x, y, parts):
        self.x, self.y, self.parts = x, y, parts

    def distribute_into_chunks(self, kind, n_clients, alpha=0.5):
        if n_clients != len(self.parts):
            raise ValueError(f"the job asks for {n_clients} clients; the benchmark's "
                             f"partition has {len(self.parts)}")
        return self.x, self.y, self.parts


@contextlib.contextmanager
def benchmark_data(make):
    """The campaign's dataset factory answering with ``make(fl_seed)``."""
    from repro_torch.runtime import campaign
    orig = campaign.make_dataset
    campaign.make_dataset = lambda raw, fl, cfg=None: make(fl.seed)
    try:
        yield
    finally:
        campaign.make_dataset = orig


def job_dict(cell: dict, cfg: dict, fl_seeds: list) -> dict:
    t = cell["traffic"]
    train = dict(t["train"], seed=fl_seeds[0], compression="int8", rounds=10**9)
    return {"name": cell["name"], "model": {"arch": cfg["port_arch"]},
            "dataset": {"dataset": "synthetic_vision", "n_items": t["data"]["n_items"],
                        "distribution": {"partition": "dirichlet",
                                         "dirichlet_alpha": t["partition"]["alpha"]}},
            "strategy": {"strategy": "compressed", "train_params": train},
            "runtime": dict(t["runtime"]),
            "sweep": {"seed": fl_seeds, "client_lr": t["client_lr"]}}


def norms(p: dict, p0: dict) -> dict:
    """Each leaf's norm of its change from ``p0``."""
    return {k: float((p[k] - p0[k]).norm()) for k in p0}


def change_norms(params: dict, p0: list) -> list:
    """Per lane of the stacked ``params``, ``norms`` from the lane's weights."""
    return [norms({k: v[s] for k, v in params.items()}, p0[s]) for s in range(len(p0))]


class Run:
    span = "chunk"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        from repro_torch.core.jobs import load_job
        from repro_torch.runtime.campaign import CampaignExecutor

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = cell["traffic"]
        self.fl_seeds = list(dict.fromkeys(s for s, _ in lanes_of(cell, seed)))

        def make(fl_seed):
            x, y, parts = lane_inputs(cell, seed, fl_seed, device)
            return _Dataset(x.cpu().numpy(), y.cpu().numpy(), parts)

        with benchmark_data(make):
            ex = CampaignExecutor(load_job(job_dict(cell, cfg, self.fl_seeds)),
                                  device=device).scaffold()
        self.ex = ex
        self.S = ex.S
        self.lanes = [(fl.seed, fl.client_lr) for fl in ex.fls]
        if self.lanes != lanes_of(cell, seed):
            raise RuntimeError(f"the program's lanes {self.lanes} are not the sweep's")
        weights = {s: make_weights(cfg, traffic.derive(seed, "lane", s), device)
                   for s in self.fl_seeds}
        self.p0 = [weights[s] for s, _ in self.lanes]
        params = ex.state["params"]
        if {k: tuple(v.shape[1:]) for k, v in params.items()} != leaf_shapes(cfg):
            raise RuntimeError("the program's CNN layout differs from the configuration's")
        with torch.no_grad():
            for k in params:
                params[k].copy_(torch.stack([p[k] for p in self.p0]))
        tr = t["train"]
        ex.run(1)
        self.first = change_norms(ex.state["params"], self.p0)
        ex.run(cell["ref_rounds"])
        self.after = change_norms(ex.state["params"], self.p0)
        self.losses = [[r["loss"] for r in ex.results if r["traj"] == s]
                       for s in range(self.S)]
        self.rpl = tr["rounds_per_launch"]
        self.flops = flops.cnn_train_flops_per_image(cfg) * tr["cohort"] * tr["local_steps"] \
            * tr["batch_size"]
        for _ in range(cell["setup_chunks"]):
            self.step()

    def step(self) -> dict:
        self.ex.run(self.ex.round_idx + self.rpl)     # one chunk; ends synchronized
        lane_rounds = self.rpl * len(self.ex.alive_lanes())
        return {"lane_rounds": lane_rounds, "model_flops": lane_rounds * self.flops}

    def check(self) -> dict:
        del self.ex
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_lanes(self.cell, self.cfg, self.seed, self.lanes, self.device)
        return judge(self.cell, self.losses, self.first, self.after, ref)


def reference_lanes(cell: dict, cfg: dict, seed: int, lanes: list, device,
                    prec: str = "f32", half_batch: bool = False) -> list:
    """Per lane (its trajectory seed and client lr): the reference's
    (losses, first-round change norms, change norms after ``ref_rounds``)."""
    t = cell["traffic"]
    train = dict(t["train"], **{k: t["runtime"].get(k, d) for k, d in
                                (("straggler_prob", 0.0), ("straggler_overprovision", 1.0),
                                 ("drop_prob", 0.0), ("straggler_slowdown", 4.0))})
    out = []
    for fl_seed in dict.fromkeys(s for s, _ in lanes):
        x, y, parts = lane_inputs(cell, seed, fl_seed, device)
        p0 = make_weights(cfg, traffic.derive(seed, "lane", fl_seed), device)
        for s, (ls, lr) in enumerate(lanes):
            if ls != fl_seed:
                continue
            losses, after = ref_cnn.lane_rounds(p0, x, y, parts, fl_seed, lr,
                                                cell["ref_rounds"], train, prec, half_batch)
            out.append((s, losses, norms(after[0], p0), norms(after[-1], p0)))
        del x, y
    return [o[1:] for o in sorted(out, key=lambda o: o[0])]


def judge(cell: dict, losses: list, first: list, after: list, ref: list) -> dict:
    """The median lane's gap of its first round's loss, and the worst
    lane's gaps of every leaf's first-round change and of its change after
    ``ref_rounds`` rounds. Later rounds' losses, and round 0's in the worst
    lane, swing with round-off grown by the local steps at lr 0.1, in the
    program and in the control alike; the median lane's does not."""
    gaps = {"lane_median_first_loss_gap": [], "update_gap": [], "change_gap": []}
    for s, (r_losses, r_first, r_after) in enumerate(ref):
        leaves = compare.moved(r_first)
        gaps["lane_median_first_loss_gap"].append(
            compare.loss_gap(losses[s][:1], r_losses[:1]))
        gaps["update_gap"].append(compare.norm_gap(first[s], r_first, leaves))
        gaps["change_gap"].append(compare.norm_gap(after[s], r_after, leaves))
    got = {"lane_median_first_loss_gap": compare.median(gaps["lane_median_first_loss_gap"]),
           "update_gap": compare.worst(gaps["update_gap"]),
           "change_gap": compare.worst(gaps["change_gap"])}
    lim = cell["limits"]
    return {k: {"value": v, "limit": lim.get(k)} for k, v in got.items()}


def setup(cell: dict, cfg: dict, seed: int, device) -> Run:
    return Run(cell, cfg, seed, device)


def lanes_of(cell: dict, seed: int) -> list:
    """(trajectory seed, client lr) of each lane, in the sweep's order (the
    last axis fastest)."""
    t = cell["traffic"]
    seeds = [traffic.derive(seed, "fl_seed", i) % 2**31 for i in range(t["trajectory_seeds"])]
    return [(s, lr) for s in seeds for lr in t["client_lr"]]


def control_readings(cell: dict, cfg: dict, seed: int, device) -> dict:
    """The comparison's numbers for the reference put in the program's
    place: computed in the control's precision, and with half of each
    batch left out; each judged against the float32 reference."""
    lanes = lanes_of(cell, seed)
    ref = reference_lanes(cell, cfg, seed, lanes, device)
    out = {}
    for name, kw in (("control", {"prec": cell["control"]}), ("half_batch", {"half_batch": True})):
        got = reference_lanes(cell, cfg, seed, lanes, device, **kw)
        out[name] = judge(cell, [g[0] for g in got], [g[1] for g in got],
                          [g[2] for g in got], ref)
    return out
