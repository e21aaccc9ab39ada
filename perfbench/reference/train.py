"""Plain reference of NeRF training steps, in float32 PyTorch autograd.

It imports nothing of the program. From the parameter trees, the scene's
images and poses, the configuration document and the run's seed it
follows a run's first steps: the occupancy grid refreshed from the nets
(σ the larger of the coarse and the fine net's at the G³ cell centres)
when the step count calls for it; a culled step (the configuration's
reduced budget inside each ray's interval in the grid's box, misses
composited to the background) or a dense one; a batch of rays; the
coarse pass on jittered stratified samples and the fine pass on samples
drawn from the coarse weights' mid-bin PDF joined with them; the coarse
plus fine mean squared error and the Cauchy density prior at random points
of the scan box, for both nets; Adam (β 0.9, 0.999, ε 1e-8) at the
schedule's learning rate.

Random draws: one torch.Generator on the device, seeded with the run's
seed, drawn in the order the algorithm uses them: the batch's ray indices,
the coarse jitter, the coarse σ noise (under `sampling.raw_noise_std`),
the fine quantiles, the fine σ noise, the prior's points, each step. Rays
of a forward-facing configuration (`render.ndc`) are marched in NDC with
the world directions as view directions.
`quant="fp8"` rounds both operands of every forward product to float8
e4m3 (the gradient passes as if unrounded): the control.
"""

from __future__ import annotations

import torch

from . import nerf


class Net:
    """A NeRF MLP whose kernels and biases are float32 leaves."""

    def __init__(self, tree, device, quant=None):
        self.mlp = nerf.MLP(tree, device, quant)
        self.leaves = {}
        for name in self.mlp.layers:
            k, b = self.mlp.layers[name]
            k = k.clone().requires_grad_(True)
            b = b.clone().requires_grad_(True)
            self.mlp.layers[name] = (k, b)
            self.leaves[name + "/kernel"] = k
            self.leaves[name + "/bias"] = b

    def __call__(self, x, d):
        return self.mlp(x, d)


def _ste_fp8(mlp):
    """Forward in float8 operands, gradient as if unrounded."""
    def dense(name, x):
        k, b = mlp.layers[name]
        qx = x + (nerf._fp8(x) - x).detach()
        qk = k + (nerf._fp8(k) - k).detach()
        return qx @ qk + b
    mlp._dense = dense


def box_interval(o, d, box_min, box_max, near: float, far: float):
    """Slab test of rays against one box, clipped to [near, far] → (t_lo,
    t_hi, hit), both far on a miss."""
    tiny = torch.where(d < 0, -1e-10, 1e-10)
    inv = 1.0 / torch.where(d.abs() < 1e-10, tiny, d)
    t0 = (box_min[None] - o) * inv
    t1 = (box_max[None] - o) * inv
    lo = torch.minimum(t0, t1).amax(dim=-1).clamp(near, far)
    hi = torch.maximum(t0, t1).amin(dim=-1).clamp(near, far)
    hit = hi > lo
    return torch.where(hit, lo, far), torch.where(hit, hi, far), hit


def volume_render(rgb, sigma, t, d, white: bool, t_end=None, noise=None):
    """Quadrature: δ to the next sample (the last to t_end, or 1e10), α
    of relu(σ + noise), T = ∏(1 − α + 1e-10), w = Tα → rgb, acc,
    weights."""
    if noise is not None:
        sigma = sigma + noise
    dists = t[:, 1:] - t[:, :-1]
    last = (torch.full_like(t[:, :1], nerf.INF_DIST) if t_end is None
            else torch.clamp(t_end - t[:, -1:], min=0.0))
    dists = torch.cat([dists, last], -1) * torch.linalg.norm(d, dim=-1,
                                                             keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans
    rgb_map = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    if white:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return rgb_map, acc, w


def field(net: Net, pts, d):
    """(R, S, 3) points, (R, 3) view directions → rgb (R, S, 3), σ (R, S)."""
    R, S, _ = pts.shape
    rgb, sig = net(pts.reshape(-1, 3), d.repeat_interleave(S, dim=0))
    return rgb.view(R, S, 3), sig.view(R, S)


def learning_rate(train: dict, step: int) -> float:
    return train["lr_init"] * (train["lr_final"] / train["lr_init"]) ** (
        step / train["lr_decay_steps"])


def follow(cfg: dict, trees: dict, rays: dict, seed: int, start: int,
           n_steps: int, device, quant=None,
           rows_per_pass: int = 4096) -> dict:
    """Steps start … start + n_steps − 1 → dict losses [per step], grad
    {leaf: the first step's gradient}, delta {leaf: the parameters' change
    over the steps}, culled [per step]. rays: {"rays_o", "rays_d", "rgb"}
    of every pixel of the scene, view-major. The batch's loss and
    gradients are summed over passes of rows_per_pass rays (the loss is a
    mean over rays), so that the autograd graph fits the card."""
    tr, s, r, oc = cfg["train"], cfg["sampling"], cfg["render"], \
        cfg["occupancy"]
    nets = {k: Net(trees[k], device, quant) for k in ("coarse", "fine")}
    if quant == "fp8":
        for n in nets.values():
            _ste_fp8(n.mlp)
    leaves = {f"{k}/{n}": v for k, net in nets.items()
              for n, v in net.leaves.items()}
    start_vals = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    n_total = rays["rays_o"].shape[0]
    B = tr["batch_rays"]
    occ, out = None, {"losses": [], "culled": []}
    up = torch.tensor([[0.0, 0.0, -1.0]], device=device)
    with nerf.exact_f32():
        for t_step, i in enumerate(range(start, start + n_steps), 1):
            if tr["occ_train"] and i >= tr["occ_warmup"] and (
                    occ is None or i % tr["occ_refresh_every"] == 0):
                with torch.no_grad():
                    occ = nerf.occupancy(
                        lambda p: torch.maximum(
                            nets["coarse"](p, up.expand(p.shape[0], 3))[1],
                            nets["fine"](p, up.expand(p.shape[0], 3))[1]),
                        oc, device)
            culled = occ is not None and (i + 1) % tr["occ_dense_every"] != 0
            n_c = tr["occ_coarse"] if culled else s["n_coarse"]
            n_f = tr["occ_fine"] if culled else s["n_fine"]
            # every draw of the step, in the algorithm's order
            draw = _draws(gen, device, n_total, B, n_c, n_f, s, tr, oc)
            loss = 0.0
            grads = [torch.zeros_like(v) for v in leaves.values()]
            for rows in torch.arange(B, device=device).split(rows_per_pass):
                part = _rays_loss(cfg, nets, rays, occ if culled else None,
                                  draw, rows, n_c, B)
                loss += float(part.detach())
                for g, p in zip(grads, torch.autograd.grad(
                        part, list(leaves.values()))):
                    g += p
            if tr["sparsity_weight"] > 0:
                dd = up.expand(draw["prior"].shape[0], 3)
                prior = tr["sparsity_weight"] * sum(torch.log1p(
                    0.5 * torch.relu(field(nets[k], draw["prior"], dd)[1])
                    ** 2).mean() for k in ("coarse", "fine"))
                loss += float(prior.detach())
                for g, p in zip(grads, torch.autograd.grad(
                        prior, list(leaves.values()), allow_unused=True)):
                    if p is not None:
                        g += p
            lr = learning_rate(tr, i)
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    if t_step == 1:
                        out.setdefault("grad", {})[k] = g.clone()
                    m[k].mul_(0.9).add_(g, alpha=0.1)
                    v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                    mh = m[k] / (1 - 0.9 ** t_step)
                    vh = v2[k] / (1 - 0.999 ** t_step)
                    p.sub_(lr * mh / (vh.sqrt() + 1e-8))
            out["losses"].append(loss)
            out["culled"].append(culled)
    out["delta"] = {k: (v.detach() - start_vals[k]) for k, v in
                    leaves.items()}
    return out


def _draws(gen, device, n_total: int, B: int, n_c: int, n_f: int,
           sampling: dict, tr: dict, occ_cfg: dict) -> dict:
    """A step's random draws, in the order the step uses them."""
    std = sampling["raw_noise_std"]

    def noise(shape):
        if std <= 0:
            return None
        return torch.randn(shape, generator=gen, device=device) * std

    out = {"idx": torch.randint(0, n_total, (B,), generator=gen,
                                device=device)}
    out["jitter"] = torch.rand((B, n_c), generator=gen, device=device)
    out["noise_c"] = noise((B, n_c))
    out["u"] = torch.rand((B, n_f), generator=gen, device=device)
    out["noise_f"] = noise((B, n_c + n_f))
    if tr["sparsity_weight"] > 0:
        # the density prior's points, uniform in the occupancy scan box
        lo, hi = occ_cfg["world_min"], occ_cfg["world_max"]
        out["prior"] = lo + (hi - lo) * torch.rand(
            (tr["sparsity_points"], 1, 3), generator=gen, device=device)
    return out


def _rays_loss(cfg: dict, nets: dict, rays: dict, occ, draw: dict, rows,
               n_c: int, B: int):
    """The coarse plus fine squared error of the batch's rays `rows`,
    summed and divided by the batch's element count: their part of the
    batch's mean."""
    r = cfg["render"]
    idx = draw["idx"][rows]
    o, d, vd, target = (rays["rays_o"][idx], rays["rays_d"][idx],
                        rays["viewdirs"][idx], rays["rgb"][idx])
    n = o.shape[0]
    near, far, hit, t_end = r["near"], r["far"], None, None
    if occ is not None:
        near, far, hit = box_interval(o, d, occ["box_min"], occ["box_max"],
                                      near, far)
        t_end = r["far"]
    else:
        near = torch.full((n,), near, device=o.device)
        far = torch.full((n,), far, device=o.device)
    z = nerf.linspace_rays(near, far, n_c)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    z = lower + (upper - lower) * draw["jitter"][rows]
    pts = o[:, None] + d[:, None] * z[..., None]
    rgb_s, sig_s = field(nets["coarse"], pts, vd)
    rgb_c, _, w_c = volume_render(
        rgb_s, sig_s, z, d, r["white_bkgd"], t_end,
        None if draw["noise_c"] is None else draw["noise_c"][rows])
    t_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    t_f = _inverse_cdf(t_mid, w_c[:, 1:-1].detach(), draw["u"][rows])
    t_all = torch.sort(torch.cat([z, t_f], -1), -1).values
    pts = o[:, None] + d[:, None] * t_all[..., None]
    rgb_s, sig_s = field(nets["fine"], pts, vd)
    rgb_f, _, _ = volume_render(
        rgb_s, sig_s, t_all, d, r["white_bkgd"], t_end,
        None if draw["noise_f"] is None else draw["noise_f"][rows])
    if hit is not None:
        bg = 1.0 if r["white_bkgd"] else 0.0
        rgb_c = torch.where(hit[:, None], rgb_c, bg)
        rgb_f = torch.where(hit[:, None], rgb_f, bg)
    return (((rgb_c - target) ** 2).sum()
            + ((rgb_f - target) ** 2).sum()) / (3 * B)


def _inverse_cdf(bins, weights, u, eps: float = 1e-5):
    """Inverse-CDF samples of the piecewise-constant PDF at quantiles u."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def scene_rays(images, poses, focal: float, device, ndc: bool) -> dict:
    """Every pixel's ray of the posed views, view-major and row-major;
    under ndc, marched in NDC with the world directions as viewdirs."""
    N, H, W, _ = images.shape
    os_, ds_ = [], []
    for p in poses:
        o, d = nerf.camera_rays(H, W, focal, p, device)
        os_.append(o)
        ds_.append(d)
    o, d = torch.cat(os_), torch.cat(ds_)
    vd = d
    if ndc:
        o, d = nerf.to_ndc(H, W, focal, 1.0, o, d)
    return {"rays_o": o, "rays_d": d, "viewdirs": vd,
            "rgb": images.reshape(-1, 3).float().to(device)}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms: |‖prog‖ − ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖, over the leaves `keep` names (all
    by default)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(ref[k].norm()) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med)
               for k in names)


def moved_leaves(grad: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k for k, v in norms.items() if v >= share * med}
