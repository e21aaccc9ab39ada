"""PyTorch/CUDA port of fashion_nerf for one NVIDIA H100.

The JAX package `fashion_nerf` stays the reference. This package imports
`torch` and never `jax`, and nothing of `fashion_nerf`: it keeps its own
copies of the reference's configuration tree (`config.py`) and asset IO
(`assets.py`).

Slices covered so far: the blockwise 800×800 `blender_lego` render
(`fashion_nerf_torch.bench.run_bench`), with hand-written Hopper kernels for
the proposal march, the fine march and the fused field; and the
`blender_lego` trainer (`python -m fashion_nerf_torch.cli train`), with
kernels for the fused field's backward and the dense volume render; the
7-pose quality gate (`python -m fashion_nerf_torch.quality --gate`) with the
generic carry march, and the tensor-core probe; the command line from a
checkpoint (`python -m fashion_nerf_torch`); and the garment try-on serving
path (`tryon/`, `preprocess`, `eval` / `render` of the try-on presets),
with the cond windows of the fused field and the generic carry march.
"""
