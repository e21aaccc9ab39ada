"""Device-resident ray pipeline; counterpart of
`fashion_nerf.data.pipeline` (`RayDataset`, `sample_batch`).

Every ray (origin, direction, view direction, colour) of the posed images
is computed once and kept on the device; a training step gathers its batch
by random indices drawn from an explicit generator.
"""

from __future__ import annotations

import numpy as np
import torch

from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays


class RayDataset:
    """Precomputed rays of N posed images on `device`.

    rays_o, rays_d, viewdirs, rgb: (N·H·W, 3) f32; frame_ids (N·H·W,)
    int64; crop_idx: indices of the centre-crop rays (precrop phase)."""

    def __init__(self, images: np.ndarray, poses: np.ndarray, focal: float,
                 ndc: bool = False, precrop_frac: float = 0.5, device=None):
        N, H, W = images.shape[:3]
        os_, ds_ = [], []
        for p in np.asarray(poses):
            o, d = generate_rays(H, W, focal, p, device=device)
            os_.append(o.reshape(-1, 3))
            ds_.append(d.reshape(-1, 3))
        rays_o, rays_d = torch.cat(os_), torch.cat(ds_)
        viewdirs = rays_d
        if ndc:
            rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        dh, dw = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
        jj, ii = np.meshgrid(np.arange(H // 2 - dh, H // 2 + dh),
                             np.arange(W // 2 - dw, W // 2 + dw),
                             indexing="ij")
        per_img = (jj * W + ii).reshape(-1)
        crop = (np.arange(N)[:, None] * (H * W) + per_img[None]).reshape(-1)
        self.rays_o, self.rays_d, self.viewdirs = rays_o, rays_d, viewdirs
        self.rgb = torch.as_tensor(
            np.ascontiguousarray(images.reshape(-1, 3)),
            dtype=torch.float32).to(rays_o.device)
        self.frame_ids = torch.arange(N, device=rays_o.device
                                      ).repeat_interleave(H * W)
        self.crop_idx = torch.as_tensor(crop, device=rays_o.device)
        self.n_rays = int(rays_o.shape[0])
        self.H, self.W, self.focal, self.N = H, W, focal, N
        self.val_image = self.val_pose = None

    def batch_arrays(self) -> dict:
        """The per-ray tensors a training step gathers from."""
        return {"rays_o": self.rays_o, "rays_d": self.rays_d,
                "viewdirs": self.viewdirs, "rgb": self.rgb,
                "frame_ids": self.frame_ids}


def sample_batch(all_rays: dict, generator, batch_rays: int, n_total: int,
                 crop_idx=None, step=None, precrop_iters: int = 0) -> dict:
    """Gather a random batch of `batch_rays` rays on the rays' device. With
    crop_idx, the indices come from the centre crop: always when step is
    None, else while step < precrop_iters."""
    dev = all_rays["rays_o"].device
    if crop_idx is not None and (step is None or step < precrop_iters):
        sel = torch.randint(0, crop_idx.shape[0], (batch_rays,),
                            generator=generator, device=dev)
        idx = crop_idx[sel]
    else:
        idx = torch.randint(0, n_total, (batch_rays,), generator=generator,
                            device=dev)
    return {k: v[idx] for k, v in all_rays.items()}
