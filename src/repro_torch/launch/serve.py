"""Serving launcher: batched prefill + greedy decode (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b [--device cpu]

``main`` drives the reduced config of an arch end to end, on the CUDA card
unless ``--device cpu`` is given. ``generate`` is the path at any size:
``chip_smoke.py`` runs it at the full width of yi-34b.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.models import model_zoo
from repro_torch.models.transformer import pad_caches
from repro_torch.runtime.device import resolve_device


@torch.inference_mode()
def generate(model, params, prompts, max_new: int = 16):
    """prompts: (B, S) int token ids -> (B, max_new) greedy tokens.

    One prefill over the prompts, the caches grown by ``max_new`` zero
    slots, then ``max_new`` decode steps (the last step's token is not
    returned, as in the JAX package)."""
    B, S = prompts.shape
    caches, logits, _ = model.prefill(params, {"tokens": prompts})
    caches = pad_caches(caches, max_new)
    out = []
    tok = model.greedy_token(logits)
    length = torch.full((B,), S, dtype=torch.int32, device=prompts.device)
    for _ in range(max_new):
        out.append(tok)
        logits, caches = model.decode_step(params, tok, caches, length)
        tok = model.greedy_token(logits)
        length = length + 1
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print(toks[:2].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()
