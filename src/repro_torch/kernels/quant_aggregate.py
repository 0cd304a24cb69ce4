"""Fused int8 dequantize + weighted client reduction (port of
``repro/kernels/quant_aggregate.py``).

``quant_aggregate`` launches the hand-written Hopper kernel
``csrc/quant_aggregate.cu`` for CUDA tensors and takes ``plain``, the same
arithmetic in PyTorch, for CPU tensors. Both compute, per output n and in
client order, ``acc = acc + (float(q[c, n]) * scale[c, n // qblock]) * w[c]``
from ``acc = 0``, so they agree bit for bit. A campaign's lanes come as a
leading dim S, ``(S, C, N)`` in one launch, each lane's result bitwise the
``(C, N)`` launch on that lane.

The kernel is bound by memory traffic: it reads each int8 byte once and
writes only the (N,) f32 result (see the note in the CUDA source). Each CTA
streams its tiles of the clients' rows through a ring in shared memory, one
TMA copy per stage; ``launch_plan`` gives that geometry.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.launch import op_cost

VEC = 16                 # qblock is a multiple of this (16-byte copies of q rows)
OUT_PER_THREAD = 8       # outputs per consumer thread of the kernel
TILES = (256, 512, 768, 1024)   # outputs per CTA the kernel takes
STAGE_CLIENTS = 8        # clients per ring stage (the kernel's most)
STAGES = 4               # ring stages: 32 KB of q in flight per CTA
SCALE_BYTES = 16 * 1024  # shared memory for one chunk of clients' scales and w (of two)
CTAS_PER_SM = 4          # CTAs at most, per SM; each takes tiles in turn
# Shared memory holds one ring of stages and two chunks of scales whatever
# the client count, so the clients are bounded only by the C entry point's
# 32-bit client count.
MAX_CLIENTS = 2**31 - 1
# Offsets into q, the scales and the output are 64-bit in the kernel; the
# TMA copy's column coordinate, in int32 words of q, is a signed 32-bit
# value, so N stays at or below 4 * (2**31 - 1) (the C entry point's kMaxN;
# minicpm3-4b's packed delta of 4.07e9 values is about half of it).
MAX_N = 4 * (2**31 - 1)


class Plan(NamedTuple):
    """Launch geometry of ``csrc/quant_aggregate.cu``: tiles of ``tile``
    outputs (8 per consumer thread; ``threads`` counts the producer warp
    too), taken in turn by ``grid`` CTAs, each streaming ``stage_clients``
    clients per stage through a ring of ``stages`` stages, with the scales
    and w of ``chunk`` clients at a time in shared memory, the next chunk's
    arriving while one is used (``smem`` bytes in all)."""
    tile: int
    stage_clients: int
    stages: int
    chunk: int
    threads: int
    grid: int
    smem: int

    def launch_args(self):
        """The geometry as the C entry point takes it."""
        return self.tile, self.stage_clients, self.stages, self.chunk, self.grid


def launch_plan(C: int, N: int, qblock: int, sm_count: int = 132,
                tile: int | None = None, S: int = 1) -> Plan:
    """The kernel's geometry for S lanes of C clients of N int8 values in
    scale blocks of ``qblock`` on a card of ``sm_count`` SMs. The tile (a
    multiple of 256 outputs up to 1024: a TMA box row is at most 256 int32)
    is the largest that puts within 10 % of the fewest outputs on the
    busiest SM, whose consumers' int8 arithmetic sets the pace, over the
    S * ceil(N / tile) tiles of every lane; ``tile`` forces one, to time
    the others. Raises
    for more than ``MAX_CLIENTS`` clients in all."""
    if S < 1 or not 0 <= S * C <= MAX_CLIENTS:
        raise ValueError(f"quant_aggregate takes 0..{MAX_CLIENTS} clients over "
                         f"S >= 1 lanes, got S={S}, C={C}")
    if N < 1 or qblock < VEC or qblock % VEC or N % qblock:
        raise ValueError(f"quant_aggregate wants N a whole number of scale blocks, "
                         f"qblock a multiple of {VEC}; got N={N}, qblock={qblock}")
    if N > MAX_N:
        raise ValueError(f"quant_aggregate takes N up to {MAX_N} (the TMA column is a "
                         f"signed 32-bit word index), got N={N}")
    if tile is None:
        # the largest tile within 10 % of the fewest outputs on the busiest
        # SM: a small tile leaves each CTA few consumer threads
        busiest = {t: math.ceil(S * math.ceil(N / t) / sm_count) * t for t in TILES}
        tile = max(t for t in TILES if busiest[t] <= 1.1 * min(busiest.values()))
    if tile not in TILES:
        raise ValueError(f"quant_aggregate tiles are {TILES} outputs, got {tile}")
    stage_clients = max(1, min(STAGE_CLIENTS, C))
    stages = max(1, min(STAGES, math.ceil(C / stage_clients)))
    # a chunk: whole stages of clients whose scales (at most tile // qblock
    # + 2 blocks a tile can touch) and w fit SCALE_BYTES, at most all of them
    per_client = 4 * (tile // qblock + 3)
    chunk = min(math.ceil(C / stage_clients),
                max(1, SCALE_BYTES // per_client // stage_clients)) * stage_clients
    chunk = max(chunk, stage_clients)
    smem = stages * (stage_clients * tile + 16) + 2 * chunk * per_client
    grid = min(S * math.ceil(N / tile), CTAS_PER_SM * sm_count)
    return Plan(tile, stage_clients, stages, chunk, tile // OUT_PER_THREAD + 32, grid, smem)


def plain(qdeltas, scales, weights):
    """The kernel's plain PyTorch version: client-ordered accumulation of
    ``(q * scale) * w`` over (nblocks, qblock) views; no (C, N) f32 buffer.
    ``(S, C, N)`` lanes run lane by lane into ``(S, N)``."""
    if qdeltas.dim() == 3:
        return torch.stack([plain(q, s, w) for q, s, w in
                            zip(qdeltas, scales, weights)])
    C, N = qdeltas.shape
    nblocks = scales.shape[-1]
    out = torch.zeros((nblocks, N // nblocks), dtype=torch.float32,
                      device=qdeltas.device)
    for c in range(C):
        deq = qdeltas[c].to(torch.float32).reshape(nblocks, -1) \
            * scales[c, :, None]
        out = out + deq * weights[c]
    return out.reshape(N)


def _check(qdeltas, scales, weights):
    """-> (S, C, N, qblock), S = 1 for ``(C, N)`` inputs; raises on shapes
    or dtypes the kernel does not take."""
    lanes = qdeltas.dim() == 3
    if qdeltas.dim() not in (2, 3) or scales.dim() != qdeltas.dim() \
            or weights.dim() != qdeltas.dim() - 1 \
            or (lanes and not scales.shape[0] == weights.shape[0] == qdeltas.shape[0]):
        raise ValueError(
            f"quant_aggregate wants q ([S,] C, N), scale ([S,] C, N/qblock), "
            f"w ([S,] C); got {tuple(qdeltas.shape)}, {tuple(scales.shape)}, "
            f"{tuple(weights.shape)}")
    if (qdeltas.dtype, scales.dtype, weights.dtype) != \
            (torch.int8, torch.float32, torch.float32):
        raise TypeError(f"quant_aggregate wants int8/f32/f32, got "
                        f"{qdeltas.dtype}/{scales.dtype}/{weights.dtype}")
    S = qdeltas.shape[0] if lanes else 1
    C, N = qdeltas.shape[-2:]
    if scales.shape[-2] != C or weights.shape[-1] != C or scales.shape[-1] == 0:
        raise ValueError(f"client dims disagree: q {tuple(qdeltas.shape)}, "
                         f"scale {tuple(scales.shape)}, w {tuple(weights.shape)}")
    if N % scales.shape[-1]:
        raise ValueError(f"N={N} is not a whole number of scale blocks "
                         f"({scales.shape[-1]})")
    qblock = N // scales.shape[-1]
    if qblock % VEC:
        raise ValueError(f"qblock={qblock} must be a multiple of {VEC}")
    return S, C, N, qblock


def cost(S: int, C: int, N: int, qblock: int) -> tuple:
    """(operations, bytes) of one launch over S lanes of C clients' N int8
    values: 3 operations a value (dequantize, weigh, add); the int8 rows,
    the f32 scales and weights read once, the f32 (N,) result written once
    a lane."""
    return 3 * S * C * N, S * (C * N + 4 * C * (N // qblock) + 4 * C + 4 * N)


def quant_aggregate(qdeltas, scales, weights):
    """-> (N,) f32: ``sum_c weights[c] * dequant(qdeltas[c])``; with a lane
    dim, ``(S, C, N)`` -> ``(S, N)``, every lane in one launch.

    CPU tensors take ``plain``; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise. Each launch adds one to
    ``quant_aggregate.launches`` and to its shape's, ``(S, C, N, qblock)``,
    in ``quant_aggregate.launches_by_shape``. Meta tensors (a dry run) get
    the output, and no launch. On either, a launch records ``cost`` in an
    open ``launch/op_cost.cost_scope``."""
    S, C, N, qblock = _check(qdeltas, scales, weights)
    devices = {t.device for t in (qdeltas, scales, weights)}
    if len(devices) != 1:
        raise ValueError(f"quant_aggregate inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return plain(qdeltas, scales, weights)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"quant_aggregate runs on cpu or cuda (or meta, for a dry run), "
                         f"not {dev}")
    if not (qdeltas.is_contiguous() and scales.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("quant_aggregate wants contiguous inputs")
    if qdeltas.data_ptr() % 16:
        raise ValueError("quant_aggregate wants q aligned to 16 bytes")
    key = (S, C, N, qblock)
    if dev.type == "meta":
        out = torch.empty(qdeltas.shape[:-2] + (N,), dtype=torch.float32, device=dev)
    else:
        plan = launch_plan(C, N, qblock, _sm_count(dev.index if dev.index is not None
                                                  else torch.cuda.current_device()), S=S)
        out = _launch(qdeltas, scales, weights, qblock, plan)
        quant_aggregate.launches += 1
        quant_aggregate.launches_by_shape[key] = quant_aggregate.launches_by_shape.get(key, 0) + 1
    if op_cost.active():
        op_cost.record_kernel("quant_aggregate", key, *cost(*key))
    return out


quant_aggregate.launches = 0
quant_aggregate.launches_by_shape = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(qdeltas, scales, weights, qblock: int, plan: Plan):
    """One launch of the kernel with ``plan``'s geometry into a new (N,)
    (or, for (S, C, N) lanes, (S, N)) output; raises if the card refuses
    it. Counts nothing: ``quant_aggregate`` counts the main path's
    launches."""
    C, N = qdeltas.shape[-2:]
    S = qdeltas.shape[0] if qdeltas.dim() == 3 else 1
    dev = qdeltas.device
    out = torch.empty(qdeltas.shape[:-2] + (N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().quant_aggregate_launch(
            qdeltas.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
            S, C, N, qblock, *plan.launch_args(), stream)
    if rc != 0:
        # 1, cudaErrorInvalidValue: the entry point's argument check refused
        # them (the geometry, or N above its kMaxN)
        why = f", its arguments refused (N up to {MAX_N})" if rc == 1 else ""
        raise RuntimeError(f"quant_aggregate kernel launch failed ({plan}): CUDA error "
                           f"{rc}{why}")
    return out


def _lib():
    from repro_torch.kernels import build
    lib = build.load("quant_aggregate")
    fn = lib.quant_aggregate_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
