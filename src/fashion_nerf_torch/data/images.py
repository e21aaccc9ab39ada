"""Image files → float arrays, for the loaders (blender, llff, viton).

PNGs go through the port's own decoder (`png.read_png`), since the card's
machine has neither PIL nor imageio; any other format is read through PIL,
or imageio where PIL does not import, and raises an error naming the file
when neither does.
"""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """An 8-bit image file → f32 in [0, 1], (H, W) or (H, W, C)."""
    if path.lower().endswith(".png"):
        from fashion_nerf_torch.png import read_png
        return read_png(path).astype(np.float32) / 255.0
    try:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im)
    except ImportError:
        try:
            import imageio.v2 as imageio
        except ImportError:
            raise RuntimeError(f"{path}: decoding this image needs PIL or "
                               "imageio, and neither imports here") from None
        arr = np.asarray(imageio.imread(path))
    return arr.astype(np.float32) / 255.0
