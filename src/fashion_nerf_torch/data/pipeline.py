"""Ray pipeline; counterpart of `fashion_nerf.data.pipeline`
(`RayDataset`, `ray_dataset`, `sample_batch`, `host_batch_iter`,
`prefetch_to_device`).

Every ray (origin, direction, view direction, colour) of the posed images
is computed once and kept on the device; a training step gathers its batch
by random indices drawn from an explicit generator. For a dataset that
does not fit the device (`data.stream`), the host draws the batches
(`host_batch_iter`, the reference's numpy draws) and `prefetch_to_device`
keeps a few in flight to the device.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator, Optional

import numpy as np
import torch

from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
from fashion_nerf_torch.kernels import resolve_device
from fashion_nerf_torch.prng import randint


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


def ray_dataset(cfg, images, poses, focal, **kw) -> RayDataset:
    """The device-resident ray set of a config (its NDC and precrop
    settings)."""
    return RayDataset(images, poses, focal, ndc=cfg.render.ndc,
                      precrop_frac=cfg.train.precrop_frac, **kw)


def sample_batch(all_rays: dict, generator, batch_rays: int, n_total: int,
                 crop_idx=None, step=None, precrop_iters: int = 0) -> dict:
    """Gather a random batch of `batch_rays` rays on the rays' device. With
    crop_idx, the indices come from the centre crop: always when step is
    None, else while step < precrop_iters. generator: a torch.Generator,
    or a data-parallel rank's `prng.RowDraws` (its rows of the batch)."""
    dev = all_rays["rays_o"].device
    if crop_idx is not None and (step is None or step < precrop_iters):
        idx = crop_idx[randint(crop_idx.shape[0], (batch_rays,), generator,
                               dev)]
    else:
        idx = randint(n_total, (batch_rays,), generator, dev)
    return {k: v[idx] for k, v in all_rays.items()}


def host_batch_iter(all_rays: dict, batch_rays: int, seed: int = 0):
    """Endless random ray batches on the host, as numpy: the reference's
    draws (`np.random.default_rng(seed).integers(0, n, batch_rays)` a
    batch), so the batches equal its, index for index. all_rays: tensors
    (copied to the host once) or arrays. No precrop, as in the reference
    (a streamed run resumes long after the warm-up)."""
    host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in all_rays.items()}
    n_total = host["rays_o"].shape[0]
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, n_total, batch_rays)
        yield {k: v[idx] for k, v in host.items()}


def prefetch_to_device(iterator: Iterator, size: int = 2, device=None,
                       rows: Optional[slice] = None):
    """Yield the iterator's numpy batches as tensors on `device`, keeping
    `size` batches in flight so a copy overlaps the step before it.

    On a CUDA device each batch goes through pinned host tensors,
    non-blocking copies on a side stream and an event that the consuming
    stream waits on before the batch is yielded; `record_stream` keeps the
    allocator from reusing a buffer the consumer has not finished with.
    On the CPU the batches are wrapped as they are. rows: a data-parallel
    rank's slice (`dist.mesh.ray_sharding`); only those rows are copied.
    device: CUDA unless the CPU is asked for by name (`resolve_device`)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    sl = rows if rows is not None else slice(None)

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v[sl]))
                for k, v in batch.items()}
        if not cuda:
            return host, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    queue = collections.deque(put(b) for b in itertools.islice(iterator,
                                                               size))
    while queue:
        out, ready = queue.popleft()
        nxt = next(iterator, None)
        if nxt is not None:
            queue.append(put(nxt))
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for v in out.values():
                v.record_stream(consumer)
        yield out
