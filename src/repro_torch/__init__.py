"""PyTorch + CUDA port of the MoE-PIM serving system (`repro`).

Module names mirror `repro` so each module's reference counterpart is easy to
find. The package imports torch and numpy only: nothing of JAX and nothing of
`repro`. Hand-written Hopper kernels live under `kernels/csrc/` and are built
with nvcc at first use (`kernels/build.py`).

Slice 1 serves the attention family through the static-batch
`launch.serve.generate()` on a dense KV cache with the GO cache.
"""
