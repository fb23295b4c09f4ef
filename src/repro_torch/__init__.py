"""PyTorch / CUDA port of the Ozaki-scheme FP64 emulation package ``repro``.

The layout mirrors ``repro``: ``core`` (moduli, error-free transformations,
Phase-1 splitting, Ozaki-II, compensated reductions, the dispatch seam),
``kernels`` (the hand-written Hopper kernels, their plain torch versions and
the wrappers around them) and ``hpc`` (the solvers).  Functions that take
tensors run on the tensors' device; functions that make tensors from nothing
take ``device=`` (default ``"cuda"``) and raise when the device is missing.
"""
