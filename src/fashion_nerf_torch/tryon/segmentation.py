"""Person parse → masks and the cloth-agnostic image; counterpart of
`fashion_nerf.tryon.segmentation`.

Parse maps label pixels by body part (VITON-HD / LIP labels). Morphology is
a stride-1 max pool whose padding takes no part in the max, as the
reference's `reduce_window(..., "SAME")` with a ±inf init does.
`resize_image` reproduces `jax.image.resize`: "bilinear" is the triangle
kernel, widened by the scale when it downscales (antialiased) and
renormalised per output pixel, applied as one weight matrix per axis;
"nearest" takes the input pixel under each output pixel's centre.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LABELS = {
    "background": 0, "hair": 2, "face": 13, "upper": 5, "dress": 6,
    "coat": 7, "pants": 9, "left_arm": 14, "right_arm": 15,
    "left_leg": 16, "right_leg": 17,
}
GARMENT_LABELS = (5, 6, 7)
SKIN_LABELS = (14, 15)
HEAD_LABELS = (2, 13)


def parse_to_masks(parse, garment_labels=GARMENT_LABELS) -> dict:
    """parse (H, W) int → dict of f32 masks: garment, body, head,
    background."""
    parse = parse.to(torch.int32)

    def any_of(labels):
        m = torch.zeros(parse.shape, dtype=torch.bool, device=parse.device)
        for label in labels:
            m = m | (parse == label)
        return m.float()

    background = (parse == 0).float()
    return {"garment": any_of(garment_labels), "body": 1.0 - background,
            "head": any_of(HEAD_LABELS), "background": background}


def dilate(mask, radius: int = 2):
    """Binary dilation of an (H, W) mask by a (2r+1)² square."""
    k = 2 * radius + 1
    return F.max_pool2d(mask[None, None], k, stride=1, padding=radius)[0, 0]


def erode(mask, radius: int = 2):
    k = 2 * radius + 1
    return -F.max_pool2d(-mask[None, None], k, stride=1,
                         padding=radius)[0, 0]


def make_agnostic(image, parse, dilate_radius: int = 3,
                  fill_value: float = 0.5):
    """Grey out the dilated garment region of image (H, W, 3) → (agnostic
    (H, W, 3), masks dict)."""
    masks = parse_to_masks(parse)
    g = dilate(masks["garment"], dilate_radius)[..., None]
    return image * (1.0 - g) + fill_value * g, masks


def _weight_mat(n_in: int, n_out: int, device):
    """(n_in, n_out) f32 weights of jax.image's antialiased triangle
    resize (`compute_weight_mat` with translation 0)."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_image(img, H: int, W: int, method: str = "bilinear"):
    """Resize img (h, w, ...) to (H, W, ...) as `jax.image.resize` does."""
    h, w = img.shape[:2]
    if method == "nearest":
        for d, (n_in, n_out) in enumerate(((h, H), (w, W))):
            if n_in == n_out:
                continue
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=img.device) + 0.5)
                              * (n_in / n_out)).long()
            img = img.index_select(d, idx)
        return img
    if method != "bilinear":
        raise ValueError(f"resize method {method!r}: bilinear or nearest")
    img = img.float()
    if h != H:
        img = torch.tensordot(_weight_mat(h, H, img.device), img,
                              dims=([0], [0]))
    if w != W:
        img = torch.tensordot(_weight_mat(w, W, img.device), img,
                              dims=([0], [1])).transpose(0, 1)
    return img.contiguous()
