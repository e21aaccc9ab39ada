"""Plain reference of the blockwise NeRF render, in float32 PyTorch.

It imports nothing of the program. It reads the configuration document
(perfbench/configs/<config>.json, the nested "config" group) and parameter
trees in the layout of the committed assets: {net: {"params": {layer:
{"kernel": (in, out), "bias": (out,)}}}}, as numpy arrays or tensors.
Everything the program derives from them it works out again: the
occupancy grid and its macro boxes, the proposal's samples, the fine
samples, the marches and the compositing.

The algorithm is the blockwise render of NeRF (Mildenhall et al., ECCV
2020) with the culling, proposal and early-termination scheme of the
configuration: rays in 8×8 pixel blocks; per ray the union interval of the
occupied macro boxes; a σ-only proposal march over one block of samples
(or, without a proposal, the full coarse march); an edge-bin PDF dilated
and mixed with a uniform floor, sampled at evenly spaced quantiles; the
fine march over blocks of `kernels.block_samples` samples. Early
termination is per predication tile of 2048 / SB rays, as the
configuration's algorithm defines it: a (tile, block) pair is marched
whole when some ray of the tile is still alive (hit, its block overlaps an
occupied box, transmittance above `kernels.early_term_eps`), and a pair
that is not adds nothing.

Every matrix product is float32 with TF32 off. `quant="fp8"` rounds both
operands of every product to float8 e4m3 with a scale per tensor: the
control that has to fail the comparison (perfbench/README.md).
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

TILE_ROWS = 2048          # MLP rows of one predication tile
LOG_FLOOR = math.log(1e-10)
INF_DIST = 1e10
FP8_MAX = 448.0           # largest finite float8 e4m3


@contextmanager
def exact_f32():
    """Float32 matrix products without TF32 for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x):
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def posenc(x, L: int):
    """[x, sin(2^0 x), cos(2^0 x), …, sin(2^(L-1) x), cos(2^(L-1) x)]."""
    freqs = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


class MLP:
    """The NeRF MLP of one parameter tree: a ReLU trunk with γ(x) joined
    again after each skip layer, then either σ, a feature layer, γ(d̂) and
    the view layer to rgb, or one 4-wide head (rgb, σ) without a view
    branch. The skip layers, widths and L are read off the kernels."""

    def __init__(self, tree, device, quant=None):
        p = tree["params"] if "params" in tree else tree

        def t(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a, dtype=torch.float32,
                                   device=device)

        self.layers = {k: (t(v["kernel"]), t(v["bias"])) for k, v in p.items()}
        self.depth = sum(1 for k in p if k.startswith("trunk_"))
        rows0, self.width = self.layers["trunk_0"][0].shape
        self.L = (rows0 // 3 - 1) // 2
        self.skips = {i - 1 for i in range(1, self.depth)
                      if self.layers[f"trunk_{i}"][0].shape[0] > self.width}
        self.has_vd = "view_0" in self.layers
        if self.has_vd:
            cd = self.layers["view_0"][0].shape[0] - self.width
            self.Ld = (cd // 3 - 1) // 2
        self.quant = quant

    def _dense(self, name, x):
        k, b = self.layers[name]
        if self.quant == "fp8":
            return _fp8(x) @ _fp8(k) + b
        return x @ k + b

    def __call__(self, x, d=None):
        """x (n, 3) positions, d (n, 3) view directions → rgb (n, 3) after
        the sigmoid, σ (n,) before the activation."""
        x_enc = posenc(x, self.L)
        h = x_enc
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips and i + 1 < self.depth:
                h = torch.cat([x_enc, h], dim=-1)
        if not self.has_vd:
            out = self._dense("out_head", h)
            return torch.sigmoid(out[:, :3]), out[:, 3]
        sigma = self._dense("sigma_head", h)[:, 0]
        feat = self._dense("feature", h)
        d_unit = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        h2 = torch.relu(self._dense("view_0", torch.cat(
            [feat, posenc(d_unit, self.Ld)], dim=-1)))
        return torch.sigmoid(self._dense("rgb_head", h2)), sigma


# --- cameras -----------------------------------------------------------------

def camera_rays(H: int, W: int, focal: float, c2w, device):
    """Pinhole rays of every pixel, row-major → (o, d) (H·W, 3); the camera
    looks down −z, +y up; d is not normalised."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    dirs = torch.stack([(ii - W * 0.5) / focal, -(jj - H * 0.5) / focal,
                        -torch.ones_like(ii)], dim=-1).reshape(-1, 3)
    rot = c2w[:3, :3]
    d = (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
         + dirs[:, 2:3] * rot[:, 2])
    return c2w[:3, 3].expand(d.shape), d


def to_ndc(H: int, W: int, focal: float, near: float, o, d):
    """Forward-facing rays moved to the z = −near plane and mapped to NDC."""
    t = -(near + o[:, 2]) / d[:, 2]
    o = o + t[:, None] * d
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    return (torch.stack([ax * ox / oz, ay * oy / oz, 1.0 + 2.0 * near / oz],
                        dim=-1),
            torch.stack([ax * (dx / dz - ox / oz), ay * (dy / dz - oy / oz),
                         -2.0 * near / oz], dim=-1))


def block_order(H: int, W: int):
    """Pixel permutation into 8×8 blocks (identity unless H and W are
    multiples of 8) → (order, inverse) numpy."""
    if H % 8 or W % 8:
        ident = np.arange(H * W)
        return ident, ident
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    key = ((yy // 8) * (W // 8) + xx // 8) * 64 + (yy % 8) * 8 + xx % 8
    order = np.argsort(key.reshape(-1), kind="stable")
    return order, np.argsort(order, kind="stable")


# --- occupancy ---------------------------------------------------------------

def occupancy(sigma_fn, occ_cfg: dict, device, chunk: int = 1 << 18):
    """σ (sigma_fn: points (n, 3) → raw σ (n,)) at the G³ cell centres
    over [world_min, world_max]³, thresholded, dilated by the margin,
    reduced to the tight box and to macro³ boxes → dict box_min, box_max
    (3,), boxes_min, boxes_max (K, 3), boxes_occ (K,), grid (G, G, G)."""
    g, k = occ_cfg["resolution"], max(occ_cfg["macro"], 1)
    lo, hi = float(occ_cfg["world_min"]), float(occ_cfg["world_max"])
    cell = (hi - lo) / g
    margin = occ_cfg["margin_cells"]
    if occ_cfg["margin_world"] > 0:
        margin = max(margin, int(math.ceil(occ_cfg["margin_world"] / cell)))
    ax = lo + cell * (torch.arange(g, dtype=torch.float32, device=device)
                      + 0.5)
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    sig = torch.cat([sigma_fn(p) for p in pts.split(chunk)])
    grid = (torch.relu(sig) > occ_cfg["sigma_threshold"]).reshape(g, g, g)
    if not bool(grid.any()):
        raise ValueError("the occupancy grid is empty")
    idx = grid.nonzero()
    box_min = lo + cell * (idx.min(dim=0).values - margin).clamp(0, g).float()
    box_max = lo + cell * (idx.max(dim=0).values + 1 + margin).clamp(
        0, g).float()
    m = g // k
    dil = grid
    if margin > 0:
        dil = F.max_pool3d(grid[None, None].float(), 2 * margin + 1,
                           stride=1, padding=margin)[0, 0] > 0
    sub = dil.reshape(k, m, k, m, k, m)
    occ_k = sub.any(dim=5).any(dim=3).any(dim=1).reshape(-1)
    los, his = [], []
    for dim, axis in enumerate((1, 3, 5)):
        shape = [1] * 6
        shape[axis] = m
        ids = torch.arange(m, device=device).reshape(shape)
        first = torch.where(sub, ids, m).amin(dim=(1, 3, 5))
        last = torch.where(sub, ids, -1).amax(dim=(1, 3, 5))
        bshape = [1, 1, 1]
        bshape[dim] = k
        base = (torch.arange(k, device=device) * m).reshape(bshape)
        los.append((base + first.clamp(0, m)).reshape(-1))
        his.append((base + (last + 1).clamp(0, m)).reshape(-1))
    return {"box_min": box_min, "box_max": box_max,
            "boxes_min": lo + cell * torch.stack(los, -1).float(),
            "boxes_max": lo + cell * torch.stack(his, -1).float(),
            "boxes_occ": occ_k, "grid": grid}


def box_segments(o, d, occ: dict, near: float, far: float):
    """Slab test of rays against the macro boxes → (t_lo, t_hi, hit) of the
    union interval (far, far, False on a miss) and per-box (lo, hi, hit)."""
    tiny = torch.where(d < 0, -1e-10, 1e-10)
    inv = 1.0 / torch.where(d.abs() < 1e-10, tiny, d)
    t0 = (occ["boxes_min"][None] - o[:, None]) * inv[:, None]
    t1 = (occ["boxes_max"][None] - o[:, None]) * inv[:, None]
    s_lo = torch.minimum(t0, t1).amax(dim=-1).clamp(near, far)
    s_hi = torch.maximum(t0, t1).amin(dim=-1).clamp(near, far)
    s_hit = (s_hi > s_lo) & occ["boxes_occ"][None]
    hit = s_hit.any(dim=1)
    t_lo = torch.where(s_hit, s_lo, far).amin(dim=1)
    t_hi = torch.where(s_hit, s_hi, near).amax(dim=1)
    return (torch.where(hit, t_lo, far), torch.where(hit, t_hi, far), hit,
            (s_lo, s_hi, s_hit))


# --- samples and marches -----------------------------------------------------

def linspace_rays(near, far, n: int):
    """n evenly spaced depths from near to far, per ray."""
    u = torch.linspace(0.0, 1.0, n, device=near.device)
    return near[:, None] * (1.0 - u) + far[:, None] * u


def inverse_cdf(bins, weights, n: int, eps: float = 1e-5):
    """Samples at n evenly spaced quantiles of the piecewise-constant PDF
    (bins (R, B+1) edges, weights (R, B)); a floor eps on every weight."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
        cdf.shape[0], n).contiguous()
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def widths(t, dnorm, t_end):
    """Each sample's interval to the next (the last to t_end, or to
    infinity without one), times ‖d‖."""
    last = (t[:, -1:] + INF_DIST if t_end is None
            else torch.clamp(t[:, -1:], min=float(t_end)))
    return (torch.cat([t[:, 1:], last], dim=1) - t) * dnorm


def block_overlap(t, SB: int, seg):
    """(R, NB) bool: the block's [first sample, largest sample] overlaps an
    occupied box (all true without boxes)."""
    R, S = t.shape
    tb = t.reshape(R, S // SB, SB)
    if seg is None:
        return torch.ones((R, S // SB), dtype=torch.bool, device=t.device)
    s_lo, s_hi, s_hit = seg
    return ((s_lo[:, None] <= tb.amax(dim=2)[..., None])
            & (s_hi[:, None] >= tb[:, :, 0][..., None])
            & s_hit[:, None]).any(dim=-1)


def march(mlp: MLP, o, d, viewdirs, t, alive0, SB: int, seg, t_end,
          log_eps: float, rows_per_call: int = 1 << 20):
    """Blocks of SB samples with the carried log-transmittance, per
    predication tile of TILE_ROWS // SB rays → dict rgb (R, 3) (no
    background), acc (R,), weights (R, S), needed (the samples of the
    rays that were alive in their own right at each block)."""
    R, S = t.shape
    NB, rpt = S // SB, TILE_ROWS // SB
    dnorm = torch.linalg.norm(d, dim=-1, keepdim=True)
    dist = widths(t, dnorm, t_end)
    hitb = block_overlap(t, SB, seg)
    rgb = torch.zeros((R, 3), device=o.device)
    logT = torch.zeros((R,), device=o.device)
    w = torch.zeros_like(t)
    needed = 0
    for b in range(NB):
        cols = slice(b * SB, (b + 1) * SB)
        ray_alive = alive0 & hitb[:, b] & (logT > log_eps)
        needed += int(ray_alive.sum()) * SB
        idx = ray_alive.view(-1, rpt).any(dim=1).repeat_interleave(
            rpt).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        tt = t[idx, cols]
        pts = (o[idx, None] + d[idx, None] * tt[..., None]).reshape(-1, 3)
        vd = viewdirs[idx].repeat_interleave(SB, dim=0)
        rgb_s, sig = [], []
        for p, v in zip(pts.split(rows_per_call), vd.split(rows_per_call)):
            c, s = mlp(p, v)
            rgb_s.append(c)
            sig.append(s)
        rgb_s = torch.cat(rgb_s).view(-1, SB, 3)
        x = torch.relu(torch.cat(sig).view(-1, SB)) * dist[idx, cols]
        csum = torch.cumsum(torch.clamp(-x, min=LOG_FLOOR), dim=1)
        excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1)
        wb = (1.0 - torch.exp(-x)) * torch.exp(logT[idx, None] + excl)
        w[idx, cols] = wb
        rgb[idx] += (wb[..., None] * rgb_s).sum(dim=1)
        logT[idx] = logT[idx] + csum[:, -1]
    return {"rgb": rgb, "acc": w.sum(dim=1), "weights": w,
            "depth": (w * t).sum(dim=1), "needed": needed}


def fine_depths(cfg: dict, t_c, weights, n_fine: int, proposal: bool):
    """Fine samples from the coarse pass's weights: from a proposal, the
    edge-bin PDF dilated by ±dilate bins and mixed with a uniform floor;
    from a full coarse march, the mid-bin PDF with the coarse samples
    joined. Sorted."""
    mids = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    if not proposal:
        t_f = inverse_cdf(mids, weights[:, 1:-1], n_fine)
        return torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
    pc = cfg["proposal"]
    if pc["edge_bins"]:
        bins, w = torch.cat([t_c[:, :1], mids, t_c[:, -1:]], dim=1), weights
    else:
        bins, w = mids, weights[:, 1:-1]
    k = pc["dilate"]
    if k > 0:
        w = torch.cat([w[:, :1].expand(-1, k), w, w[:, -1:].expand(-1, k)],
                      dim=1).unfold(1, 2 * k + 1, 1).amax(dim=-1)
    a = pc["uniform_mix"]
    if a > 0:
        w = (1.0 - a) * w + a * w.mean(dim=-1, keepdim=True)
    t_f = inverse_cdf(bins, w, n_fine)
    if pc["union"]:
        t_f = torch.cat([t_c, t_f], dim=-1)
    return torch.sort(t_f, dim=-1).values


def budgets(cfg: dict, occupied: bool, proposal: bool):
    """(coarse samples, their block size, fine samples): the render-time
    budget applies under occupancy culling; a proposal takes its own."""
    s, r, k = cfg["sampling"], cfg["render"], cfg["kernels"]
    n_c, n_f = s["n_coarse"], s["n_fine"]
    if occupied and (r["eval_n_coarse"] or r["eval_n_fine"]):
        n_c = r["eval_n_coarse"] or n_c
        n_f = r["eval_n_fine"] or n_f
    if not proposal:
        return n_c, k["block_samples"], n_f
    p = cfg["proposal"]
    return p["eval_n"] or n_c, p["block_samples"] or k["block_samples"], n_f


def render_rays(cfg: dict, nets: dict, occ, o, d, viewdirs):
    """Rays (R a multiple of 64) → dict rgb (R, 3) with the background,
    acc (R,), and counts: alive (rays the culling keeps), alive_fine (rays
    the fine march takes), coarse_needed / fine_needed (samples)."""
    r, k = cfg["render"], cfg["kernels"]
    proposal = "proposal" in nets
    if cfg["proposal"]["cov_n"] or cfg["occupancy"]["sample_warp"]:
        raise NotImplementedError("proposal.cov_n and occupancy.sample_warp "
                                  "are not in the reference")
    n_c, sb_c, n_f = budgets(cfg, occ is not None, proposal)
    near, far = r["near"], r["far"]
    if occ is None:
        R = o.shape[0]
        t_lo = torch.full((R,), near, device=o.device)
        t_hi = torch.full((R,), far, device=o.device)
        alive0 = torch.ones((R,), dtype=torch.bool, device=o.device)
        seg, t_end = None, None
    else:
        t_lo, t_hi, alive0, seg = box_segments(o, d, occ, near, far)
        t_end = far
    eps = k["early_term_eps"]
    log_eps = math.log(eps) if eps > 0 else -1e30
    t_c = linspace_rays(t_lo, t_hi, n_c)
    if proposal:
        out_c = march(nets["proposal"], o, d, viewdirs, t_c, alive0, sb_c,
                      seg, t_end, -1e30)
        alive_f = alive0
        if cfg["proposal"]["cull_acc"] > 0:
            alive_f = alive0 & (out_c["acc"] > cfg["proposal"]["cull_acc"])
    else:
        out_c = march(nets["coarse"], o, d, viewdirs, t_c, alive0, sb_c,
                      seg, t_end, log_eps)
        alive_f = alive0
    t_all = fine_depths(cfg, t_c, out_c["weights"], n_f, proposal)
    out_f = march(nets["fine"], o, d, viewdirs, t_all, alive_f,
                  k["block_samples"], seg, t_end, log_eps)
    rgb = out_f["rgb"]
    if r["white_bkgd"]:
        rgb = rgb + (1.0 - out_f["acc"][:, None])
    return {"rgb": rgb, "acc": out_f["acc"],
            "alive": int(alive0.sum()), "alive_fine": int(alive_f.sum()),
            "coarse_needed": out_c["needed"], "fine_needed": out_f["needed"]}


def render_frame(cfg: dict, nets: dict, occ, H: int, W: int, focal: float,
                 c2w, device, chunk: int = 65536):
    """One H×W frame → dict rgb (H, W, 3), acc (H, W) on the device, and
    the counts of `render_rays` summed over the frame."""
    o, d = camera_rays(H, W, focal, c2w, device)
    viewdirs = d
    if cfg["render"]["ndc"]:
        o, d = to_ndc(H, W, focal, 1.0, o, d)
    order, inv = block_order(H, W)
    order = torch.from_numpy(order).to(device)
    o, d, viewdirs = o[order], d[order], viewdirs[order]
    n = o.shape[0]
    pad = (-n) % 64
    if pad:
        far_o = torch.full((pad, 3), 1e6, device=device)
        down = torch.zeros((pad, 3), device=device)
        down[:, 2] = -1.0
        o, d, viewdirs = (torch.cat([o, far_o]), torch.cat([d, down]),
                          torch.cat([viewdirs, down]))
    outs, counts = [], {}
    with exact_f32():
        for s in range(0, o.shape[0], chunk):
            sl = slice(s, s + chunk)
            out = render_rays(cfg, nets, occ, o[sl], d[sl], viewdirs[sl])
            outs.append((out.pop("rgb"), out.pop("acc")))
            for key, v in out.items():
                counts[key] = counts.get(key, 0) + v
    inv = torch.from_numpy(inv).to(device)
    rgb = torch.cat([c for c, _ in outs])[:n][inv].reshape(H, W, 3)
    acc = torch.cat([a for _, a in outs])[:n][inv].reshape(H, W)
    return {"rgb": rgb, "acc": acc, **counts}


def build(cfg: dict, trees: dict, device, trained: bool, quant=None):
    """The reference's nets and occupancy from the parameter trees:
    (nets, occ or None). The grid is the fine net's σ when the
    configuration culls by occupancy and the weights are trained (a
    random net has no empty space to cull)."""
    if cfg["occupancy"]["enabled"] and cfg["occupancy"]["macro"] <= 1:
        raise NotImplementedError("occupancy.macro 1 is not in the reference")
    if cfg["sampling"]["lindisp"]:
        raise NotImplementedError("sampling.lindisp is not in the reference")
    nets = {k: MLP(v, device, quant) for k, v in trees.items()}
    occ = None
    if cfg["occupancy"]["enabled"] and trained:
        dirs = torch.tensor([[0.0, 0.0, -1.0]], device=device)
        with exact_f32():
            occ = occupancy(
                lambda p: nets["fine"](p, dirs.expand(p.shape[0], 3))[1],
                cfg["occupancy"], device)
    return nets, occ
