"""The general render generator: closed-loop frames of one client.

A traffic file with "driver": "render" gives:

- "frame": [H, W] pixels of every frame;
- "fov_x": the horizontal field of view in radians (focal 0.5·W/tan(fov/2));
- "poses": {"kind": "orbit", "n", "phi_deg", "radius", "stride"}: the
  Blender render path of nerf-pytorch, n poses `pose_spherical(θ, φ, r)`
  with θ evenly over 360° (in the z-up convention of the scene the
  committed weights were trained on); frame k renders pose k·stride mod n
  in every run (stride coprime with n, so a part-orbit at the end of a
  window samples the circle evenly); or {"kind": "bench", "radius"}:
  the camera at z = radius looking down −z, every frame;
- "overrides": {dotted key: value} applied to the configuration for this
  traffic (render knobs such as "render.chunk");
- "warm_frames": frames rendered in set-up (the first of the order);
- "check_frames": frames the comparison takes after the window, drawn from
  the seed among the poses the window rendered.

The program renders through `render_image_blockwise`, set up by its own
`bench.bench_setup` (trained assets: the committed weights, the occupancy
sweep through K3, the committed proposal) or, for seeded weights, with
the benchmark's nets copied into the program's `NeRFMLP`s. A frame ends
with `torch.cuda.synchronize()`: the client waits for its pixels.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from perfbench import weights as W
from perfbench.drivers.common import cell_config, program_config, sync
from perfbench.reference import nerf as ref

UNIT_SPAN = "frame"


def pose_spherical(theta_deg: float, phi_deg: float, radius: float):
    """Camera-to-world (4×4) of a camera at `radius` from the origin
    looking at it, in the Blender scenes' z-up frame: from (0, 0, radius)
    turned by φ about x, then by θ about z (the convention of the scene the
    committed flagship weights were trained on, whose views lie at φ from
    −40° to −20°)."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(ph), -math.sin(ph), 0],
                        [0, math.sin(ph), math.cos(ph), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), -math.sin(th), 0, 0],
                          [math.sin(th), math.cos(th), 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]])
    return (rot_theta @ rot_phi @ trans).astype(np.float32)


def make_poses(spec: dict) -> list:
    if spec["kind"] == "orbit":
        n = spec["n"]
        return [pose_spherical(th, spec["phi_deg"], spec["radius"])[:3]
                for th in np.linspace(0.0, 360.0, n + 1)[:-1]]
    if spec["kind"] == "bench":
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[2, 3] = spec["radius"]
        return [c2w]
    raise ValueError(f"poses kind {spec['kind']!r}")


class Driver:
    """One cell's program, window units (frames) and comparison."""

    unit_span = UNIT_SPAN

    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device,
                 say):
        self.doc, self.traffic, self.seed = cfg_doc, traffic, seed
        self.device, self.say = device, say
        self.cfg = cell_config(cfg_doc, traffic)
        self.H, self.W = traffic["frame"]
        self.focal = 0.5 * self.W / math.tan(0.5 * traffic["fov_x"])
        self.poses = make_poses(traffic["poses"])
        n = len(self.poses)
        stride = traffic["poses"].get("stride", 1)
        if math.gcd(stride, n) != 1:
            raise ValueError(f"stride {stride} is not coprime with {n}")
        # the same frames in the same order for every seed: a seed that
        # picked the start would change which part-orbit ends the window
        self.order = [(k * stride) % n for k in range(n)]
        self.kept = {}          # pose → the window's latest rgb of it
        self.rendered = []      # pose of every window frame, in order

    # --- the program ---------------------------------------------------------

    def setup(self, timer) -> None:
        from fashion_nerf_torch import kernels as K
        from fashion_nerf_torch.bench import bench_setup
        from fashion_nerf_torch.render.blockwise import (
            render_image_blockwise)
        timer("import")
        self.pcfg = cfg = program_config(self.doc["preset"], self.cfg)
        if self.device.type == "cuda":
            K.library()
        timer("kernel library")
        trained = self.doc["weights"]["trained"]
        if self.doc["weights"]["kind"] == "seeded":
            self.trees = W.cell_trees(self.doc, self.seed, self.device)
            self.setup_out = {"params": _program_nets(cfg, self.trees,
                                                      self.device),
                              "occ": None, "cond": None}
        else:
            self.setup_out = bench_setup(cfg, self.device)
            if bool(self.setup_out["trained"]) != trained:
                raise RuntimeError("the program did not take the committed "
                                   "weights as trained for this config")
            if not self.setup_out["blockwise"]:
                raise RuntimeError("the configuration is not blockwise")
        sync(self.device)
        timer("weights, occupancy, proposal")
        self._render = render_image_blockwise

    def _frame(self, pose: int):
        s = self.setup_out
        with torch.no_grad():
            out = self._render(s["params"], self.pcfg, self.H, self.W,
                               self.focal, self.poses[pose], occ=s["occ"],
                               device=self.device, cond=s["cond"])
        sync(self.device)
        return out

    def warm(self, timer) -> None:
        for k in range(self.traffic["warm_frames"]):
            self._frame(self.order[k % len(self.order)])
        timer("warm-up frames")
        from fashion_nerf_torch import kernels as K
        K.reset_launches()

    def unit(self, k: int) -> int:
        """Frame k of the window → its rays."""
        pose = self.order[k % len(self.order)]
        self.kept[pose] = self._frame(pose)["rgb"]
        self.rendered.append(pose)
        return self.H * self.W

    def release(self) -> None:
        """The kept frames to the host, the program's state freed."""
        from fashion_nerf_torch import kernels as K
        self.say("kernel launches in the window (the program's counters): "
                 + str({k: v for k, v in K.LAUNCHES.items() if v}))
        self.kept = {p: v.float().cpu() for p, v in self.kept.items()}
        self.setup_out = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference -------------------------------------------------------

    def reference(self, poses, quant=None) -> dict:
        """{pose: reference frame dict} of these poses."""
        trees = (self.trees if hasattr(self, "trees")
                 else W.cell_trees(self.doc, self.seed, self.device))
        nets, occ = ref.build(self.cfg, trees, self.device,
                              self.doc["weights"]["trained"], quant)
        out = {}
        for p in poses:
            out[p] = ref.render_frame(self.cfg, nets, occ, self.H, self.W,
                                      self.focal, self.poses[p], self.device)
            out[p]["rgb"] = out[p]["rgb"].cpu()
            out[p]["acc"] = out[p]["acc"].cpu()
        return out

    def check(self, traced: bool) -> dict:
        """The numbers compared, over the frames drawn from the seed; when
        traced, also the reference's counts of every window frame (the
        work it needed) in self.counts."""
        check_poses = self.check_poses()
        poses = sorted(set(check_poses) | (set(self.rendered) if traced
                                           else set()))
        ref_frames = self.reference(poses)
        self.counts = [{k: v for k, v in ref_frames[p].items()
                        if k not in ("rgb", "acc")} for p in self.rendered
                       ] if traced else []
        return self.compare({p: ref_frames[p] for p in check_poses})

    def check_poses(self) -> list:
        """The poses the comparison takes: drawn from the seed among those
        the window rendered."""
        poses = sorted(self.kept)
        rng = np.random.default_rng(self.seed)
        n = min(self.traffic["check_frames"], len(poses))
        return sorted(int(p) for p in rng.choice(poses, n, replace=False))

    def compare(self, ref_frames: dict, frames: dict = None) -> dict:
        """The numbers of the rgb error against the reference, each the
        worst over the checked frames: rgb_rmse (root mean square),
        rgb_mae (mean absolute), rgb_p50 / rgb_p99 (the median and the
        99th percentile of the absolute error of every pixel and channel),
        rgb_max (the largest)."""
        frames = self.kept if frames is None else frames
        out = {"rgb_rmse": 0.0, "rgb_mae": 0.0, "rgb_p50": 0.0,
               "rgb_p99": 0.0, "rgb_max": 0.0}
        for p, r in ref_frames.items():
            err = (frames[p].float() - r["rgb"]).abs().reshape(-1)
            q = torch.quantile(err[::max(1, err.numel() // (1 << 24))],
                               torch.tensor([0.5, 0.99]))
            got = {"rgb_rmse": float(err.pow(2).mean().sqrt()),
                   "rgb_mae": float(err.mean()), "rgb_p50": float(q[0]),
                   "rgb_p99": float(q[1]), "rgb_max": float(err.max())}
            out = {k: max(v, got[k]) for k, v in out.items()}
        return out

    def control(self, quant: str) -> dict:
        """The numbers of the reference computed at `quant` put in the
        program's place, on the frames this seed's run would compare
        (drawn from the seed among all the poses)."""
        n = len(self.order)
        k = min(self.traffic["check_frames"], n)
        rng = np.random.default_rng(self.seed)
        poses = sorted(int(p) for p in rng.choice(n, k, replace=False))
        exact = self.reference(poses)
        low = self.reference(poses, quant=quant)
        return self.compare(exact, {p: low[p]["rgb"] for p in poses})

    def flops(self) -> dict:
        """Operations per evaluation of each net the reference marches."""
        from perfbench.roofline import eval_flops
        trees = (self.trees if hasattr(self, "trees")
                 else W.cell_trees(self.doc, self.seed, "cpu"))
        return {k: eval_flops(v) for k, v in trees.items()}

    def budget(self) -> tuple:
        """(coarse, fine) evaluations of a ray the configuration budgets:
        the proposal's (or the coarse march's) samples, and the fine
        march's, which joins the coarse samples without a proposal or
        under `proposal.union`."""
        prop = "proposal" in self.flops()
        occupied = (self.doc["weights"]["trained"]
                    and self.cfg["occupancy"]["enabled"])
        n_c, _, n_f = ref.budgets(self.cfg, occupied, prop)
        if not prop or self.cfg["proposal"]["union"]:
            n_f += n_c
        return n_c, n_f


def _program_nets(cfg, trees: dict, device) -> dict:
    """The program's NeRFMLPs holding the benchmark's seeded weights."""
    from fashion_nerf_torch.models.nerf_mlp import NeRFMLP
    m = cfg.model
    nets = {}
    for name, tree in trees.items():
        net = NeRFMLP(depth=m.net_depth, width=m.net_width, skips=m.skips,
                      posenc_xyz=m.posenc_xyz, posenc_dir=m.posenc_dir,
                      use_viewdirs=m.use_viewdirs,
                      compute_dtype=m.compute_dtype).to(device)
        with torch.no_grad():
            for layer_name, layer in net.named_dense():
                leaf = tree["params"][layer_name]
                layer.weight.copy_(leaf["kernel"].t())
                layer.bias.copy_(leaf["bias"])
        nets[name] = net
    return nets
