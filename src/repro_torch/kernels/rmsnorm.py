"""Fused RMSNorm (port of ``repro/kernels/rmsnorm.py``).

``rmsnorm`` launches the hand-written Hopper kernel ``csrc/rmsnorm.cu`` for
CUDA tensors and takes ``plain``, the same arithmetic in PyTorch, for CPU
tensors. Both compute ``x * rsqrt(mean(x^2) + eps) * w`` over the last dim
with f32 accumulation and return x's dtype; they sum the squares in another
order, so they agree to f32 rounding (1e-5), not bit for bit.

The kernel keeps each thread's share of a row in registers from load to
store. ``launch_plan`` decides its geometry from the shape alone: one CTA
per row, narrow when there are at least as many rows as SMs (prefill) and
wide when there are fewer (decode); a row too long for one CTA is split over
a thread-block cluster of K CTAs that add their partial sums in rank order.
``plain_cluster`` is that split in PyTorch.

``backward`` is the gradient, in torch ops on either device: the JAX
package has no backward kernel (its CPU path differentiates
``ref.rmsnorm_ref``). ``ops.rmsnorm`` puts the two together for autograd
and ``torch.func``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.launch import op_cost

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VPTS = (1, 2, 4, 8)       # vectors per thread the kernel is built for
MAX_CLUSTER = 16          # CTAs per cluster (above 8: Hopper's non-portable sizes)
# the threads a row's CTA aims at (H100 measurements in PERF.md, PR 14):
# with at least as many rows as SMs, 128 threads of 8 vectors keep the most
# bytes in flight per SM; with fewer rows, each row's CTA is alone on its
# SM, and 448 threads of 2 vectors finish its one round trip soonest
ROW_THREADS = 128
WIDE_ROW_THREADS = 512


class Plan(NamedTuple):
    """Launch geometry of ``csrc/rmsnorm.cu``: a cluster of ``K`` CTAs per
    row (1: one CTA per row), each holding ``per_cta`` elements of the row
    as ``threads`` threads of ``vpt`` vectors of ``vec`` elements.
    ``layout`` names it: "row" (one CTA per row, at least as many rows as
    SMs), "wide_row" (one CTA per row of up to 512 threads, fewer rows than
    SMs) or "cluster" (a row too long for one CTA's registers)."""
    K: int
    threads: int
    vpt: int
    vec: int
    per_cta: int
    layout: str = "row"

    def launch_args(self):
        """The geometry as the C entry point takes it."""
        return self.K, self.threads, self.vpt, self.vec, self.per_cta


def thread_bound(vec: int, vpt: int) -> int:
    """Most threads a CTA may have (the kernel's ``__launch_bounds__``)."""
    return 1024 if vec == 1 or vpt <= 2 else 2048 // vpt


def _fit(units: int, vec: int, cap: int):
    """(threads, vpt) holding ``units`` vectors in one CTA: the fewest
    vectors per thread that stay within ``cap`` threads, else the fewest
    threads under the launch bound; None if no CTA can hold them."""
    fits = [(max(32, 32 * math.ceil(math.ceil(units / v) / 32)), v) for v in VPTS]
    fits = [(t, v) for t, v in fits if t <= thread_bound(vec, v)]
    within = [(t, v) for t, v in fits if t <= cap]
    if within:
        return within[0]
    return min(fits) if fits else None


def vector_width(D: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Elements per 16-byte load of a row, or 1 (the scalar path) when D or
    the pointers do not allow 16-byte loads."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return vec if aligned and D % vec == 0 else 1


@functools.lru_cache(maxsize=256)
def launch_plan(R: int, D: int, x_dtype: torch.dtype, sm_count: int,
                aligned: bool = True, K: int | None = None) -> Plan:
    """The kernel's geometry for R rows of D elements of ``x_dtype`` on a
    card of ``sm_count`` SMs; ``aligned``: x, w and out allow 16-byte loads.
    Chosen from the shape alone.

    One CTA per row: of about ``ROW_THREADS`` threads with at least as many
    rows as SMs ("row"), of up to ``WIDE_ROW_THREADS`` with fewer
    ("wide_row"). A row too long for one CTA's registers is split over a
    cluster of the fewest CTAs (a power of two up to 16) that hold it
    ("cluster"). ``K`` forces a cluster size (1: one CTA per row), for
    timing and testing the layouts."""
    if D < 1 or R < 1:
        raise ValueError(f"rmsnorm plan wants R, D >= 1, got {R}, {D}")
    vec = vector_width(D, x_dtype, aligned)
    units = math.ceil(D / vec)
    cap = ROW_THREADS if R >= sm_count else WIDE_ROW_THREADS
    if K is None:
        K = 1
        while _fit(math.ceil(units / K), vec, cap) is None and K < MAX_CLUSTER:
            K *= 2
    if not 1 <= K <= MAX_CLUSTER:
        raise ValueError(f"rmsnorm takes clusters of 1..{MAX_CLUSTER} CTAs, got {K}")
    per_unit = math.ceil(units / K)
    fit = _fit(per_unit, vec, cap)
    if fit is None:
        raise ValueError(f"rmsnorm rows of {D} elements do not fit {K} CTAs")
    if (K - 1) * per_unit >= units:
        raise ValueError(f"rmsnorm: a cluster of {K} CTAs leaves one empty at D = {D}")
    threads, vpt = fit
    layout = "cluster" if K > 1 else ("row" if R >= sm_count else "wide_row")
    return Plan(K, threads, vpt, vec, per_unit * vec, layout)


def cta_slices(plan: Plan, D: int) -> list:
    """[start, stop) of the row elements each CTA of a cluster holds."""
    return [(r * plan.per_cta, min(D, (r + 1) * plan.per_cta)) for r in range(plan.K)]


# The kernel's plain version is the oracle itself, as the JAX package's jnp
# path is ``ref.rmsnorm_ref``.
plain = rmsnorm_ref


def plain_cluster(x, w, eps: float = 1e-6, K: int = 8):
    """The cluster layout's summation in PyTorch: the sum of squares of each
    CTA's slice of the row (``launch_plan``'s slices for a cluster of K),
    those K partials added in rank order, then ``x * rsqrt(sum / D + eps) *
    w`` in f32, returned in x's dtype."""
    D = x.shape[-1]
    plan = launch_plan(1, D, x.dtype, 1, K=K)
    xf = x.to(torch.float32)
    total = torch.zeros(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    for start, stop in cta_slices(plan, D):
        total = total + torch.sum(torch.square(xf[..., start:stop]), dim=-1, keepdim=True)
    inv = torch.rsqrt(total / D + eps)
    return (xf * inv * w.to(torch.float32)).to(x.dtype)


def backward(x, w, g, eps: float = 1e-6):
    """The gradient of ``x * rsqrt(mean(x^2) + eps) * w`` against ``g`` ->
    (dx in x's dtype, dw in w's dtype), in f32 with f32 sums:
    ``dx = inv * (g w - xhat * mean(g w xhat))``, ``dw = sum over rows of
    g xhat``, where ``inv = rsqrt(mean(x^2) + eps)`` and ``xhat = x inv``."""
    xf, gf = x.to(torch.float32), g.to(torch.float32)
    inv = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * w.to(torch.float32)
    dx = inv * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x, w):
    if w.dim() != 1 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rmsnorm wants x (..., D) and w (D,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm takes f32 or bf16, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"rmsnorm inputs on several devices: {x.device}, {w.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cost(R: int, D: int, esize: int, w_esize: int) -> tuple:
    """(operations, bytes) of one launch over R rows of D elements of
    ``esize`` bytes, w of ``w_esize``: 4 operations an element (square,
    add, scale, weight), each row read and written once and w read once."""
    return 4 * R * D, 2 * R * D * esize + D * w_esize


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D); w: (D,) -> x's shape and dtype.

    CPU tensors take ``plain``; CUDA tensors launch the kernel on the current
    stream (no synchronisation) with ``launch_plan``'s geometry, or raise.
    Each launch adds one to ``rmsnorm.launches``, to its layout's count in
    ``rmsnorm.launches_by_layout`` and to its shape's, ``(rows, D)``, in
    ``rmsnorm.launches_by_shape``. Meta tensors (a dry run,
    ``launch/dryrun.py``) get the output the kernel would write, and no
    launch. On either, a launch records ``cost`` in an open
    ``launch/op_cost.cost_scope``."""
    _check(x, w)
    dev = x.device
    if dev.type == "cpu":
        return plain(x, w, eps)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cpu or cuda (or meta, for a dry run), not {dev}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm wants contiguous inputs")
    D = x.shape[-1]
    R = x.numel() // D if D else 0
    if R >= 2**31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {R}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    if dev.type == "cuda":
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
        plan = launch_plan(R, D, x.dtype, _sm_count(dev.index if dev.index is not None
                                                    else torch.cuda.current_device()), aligned)
        _launch(x, w, out, eps, plan)
        rmsnorm.launches += 1
        rmsnorm.launches_by_layout[plan.layout] += 1
        rmsnorm.launches_by_shape[R, D] = rmsnorm.launches_by_shape.get((R, D), 0) + 1
    if op_cost.active():
        op_cost.record_kernel("rmsnorm", (R, D), *cost(R, D, x.element_size(), w.element_size()))
    return out


rmsnorm.launches = 0
rmsnorm.launches_by_layout = {"row": 0, "wide_row": 0, "cluster": 0}
rmsnorm.launches_by_shape = {}


def _launch(x, w, out, eps: float, plan: Plan):
    """One launch of the kernel with ``plan``'s geometry; raises if the card
    refuses it. Counts nothing: ``rmsnorm`` counts the main path's launches."""
    D = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   x.numel() // D, D, float(eps), DTYPE_CODES[x.dtype],
                                   DTYPE_CODES[w.dtype], *plan.launch_args(), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed ({plan}): CUDA error {rc}")
    return out


def _lib():
    from repro_torch.kernels import build
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
