"""PyTorch/CUDA port of the FLsim simulator (``repro``), slice by slice.

Mirrors ``src/repro/`` module for module where a counterpart exists, and
imports nothing of ``repro`` or ``jax``: the JAX package is the reference
the tests hold this one against, on identical numpy inputs.

Entry points (``runtime.executor.Executor``, ``core.rounds.build_multi_round``,
``launch.serve.generate``/``main``) run on the CUDA device unless the caller
passes ``device="cpu"``. Each hand-written kernel (``kernels/{quant_aggregate,
rmsnorm,flash_attention,decode_attention}`` + ``csrc/*.cu``) launches for
CUDA tensors and takes its plain PyTorch version for CPU ones.
"""
