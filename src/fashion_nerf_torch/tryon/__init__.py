"""Garment try-on preprocessing; counterpart of `fashion_nerf.tryon`.

Person-parse masks and the cloth-agnostic image, keypoint rasters, the
thin-plate-spline and flow cloth warps (`tps.py`, `flow.py`), the learned
correspondence matcher (`matcher.py`, inference), and the pipeline that
turns a person/cloth pair into the (H, W, 7) conditioning stack of the
garment-conditioned field (`pipeline.py`). Everything is plain torch on the
tensors' device; images are (H, W, C) as in the reference.
"""
