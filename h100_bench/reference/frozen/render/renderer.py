"""Neural volume renderer over a voxel feature field: the serving renderer
of `configs/serve.yaml` (counterpart of the JAX package's
`render/renderer.py`).

Lifecycle of fixed-camera serving:
  1. `prepare`             occupancy state for sampling_mode="occupancy"
                           (voxelizer channel, field probes, or their union);
  2. `plan_rays`           RayPlan: the frame's rays that hit the occupied
                           box, padded to whole tiles;
  3. `render_image`        the frame, in tiles of `render_tile` rays, each a
                           coarse + fine `render_rays` pass.

With field.use_proposal the coarse pass runs the field's small proposal
MLP, and the fine pass composites only the sorted new samples through the
full field;
`rendering_loss` then has no coarse embed term.

This frozen copy keeps the plain field only: the port's kernel paths
(field.mlp_backend "pallas_int8" / "pallas_bf16", calibrate_int8_act, the
packed weights) are left out, and such a config is refused.

Every random draw can be passed in (`draws`, `u`, `subset`, `ray_idx`), so a
test can feed the JAX package's numbers; otherwise it comes from `generator`. The
entry points run on CUDA unless the caller passes device="cpu", and raise
where CUDA is missing.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from h100_bench.reference.frozen.models.blocks import init_weights
from h100_bench.reference.frozen.models.nerf_field import (
    NerfFieldConfig, VoxelNerfField)
from h100_bench.reference.frozen.ops.compositing import (
    CompositeOut, composite, compute_weights_unsorted)
from h100_bench.reference.frozen.ops.grid_sample import expand_corners_to
from h100_bench.reference.frozen.ops.occupancy import (
    max_dilate, occupied_aabb, pool_occupancy, sample_occupancy, tighten_rays)
from h100_bench.reference.frozen.ops.rays import gen_rays
from h100_bench.reference.frozen.ops.sampling import (
    normal, sample_coarse, sample_fine, sample_fine_depth, sample_importance_z, uniform)
from h100_bench.reference.frozen.train.serve import resolve_device


class OccupancyState(NamedTuple):
    """Per-scene occupancy for sampling_mode='occupancy': the pooled and
    dilated grid (Vp, Vp, Vp) {0, 1} and the occupied AABB (2, 3)."""
    pooled: torch.Tensor
    aabb: torch.Tensor


class RayPlan(NamedTuple):
    """Active rays of a fixed (scene, camera): frame indices of the rays
    that intersect the occupied AABB, padded to whole tiles with n_total."""
    idx: torch.Tensor       # (Ra,) int64; pads = n_total
    n_active: int
    n_total: int


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(max_val / torch.sqrt(mse + 1e-20))


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Same fields and meanings as the JAX RendererConfig."""
    image_width: int = 128
    image_height: int = 128
    z_near: float = 1.2
    z_far: float = 4.0
    n_coarse: int = 64
    n_fine: int = 32
    n_fine_depth: int = 16
    depth_std: float = 0.001
    noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    ray_chunk_size: int = 512
    render_tile: int = 4096
    lambda_embed: float = 0.01
    lambda_depth: float = 0.0
    fused_gather: "bool | str" = "auto"
    reuse_coarse: bool = True
    sampling_mode: str = "stratified"   # "stratified" | "occupancy"
    occ_pool: int = 4
    occ_dilate: int = 1
    occ_probes: int = 32
    occ_floor: float = 0.002
    occ_tighten: bool = True
    occ_source: str = "voxel"           # "voxel" | "field" | "auto"
    occ_require_bounded: bool = True
    occ_field_probes: int = 8
    occ_alpha_thresh: float = 0.01
    use_ray_plan: bool = False
    late_embed: bool = True
    field: NerfFieldConfig = dataclasses.field(default_factory=NerfFieldConfig)

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0


class NeuralRenderer(nn.Module):
    """The renderer and its field's weights (`self.field`)."""

    def __init__(self, cfg: RendererConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.field.mlp_backend != "xla":
            raise ValueError("the reference renders the plain field (mlp_backend 'xla')")
        self.field = VoxelNerfField(cfg.field).to(self.device)

    # ------------------------------------------------------------- weights
    def init_params(self, generator: Optional[torch.Generator] = None) -> "NeuralRenderer":
        """Random weights drawn as flax initialises the field."""
        init_weights(self.field, generator)
        return self

    def load_field(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load the field's weights (the port's layout)."""
        self.field.load_state_dict(state_dict)
        self.field.to(self.device)

    # ---------------------------------------------------------------- core
    def _should_expand(self, n_rays: int, voxel_feat) -> bool:
        fg = self.cfg.fused_gather
        if fg != "auto":
            return bool(fg)
        c = self.cfg
        if not c.using_fine:
            per_ray = c.n_coarse
        elif c.field.use_proposal:
            per_ray = c.n_fine + (c.n_coarse if c.field.proposal_use_latent else 0)
        elif c.reuse_coarse and self.field.share_mlp:
            per_ray = c.n_coarse + c.n_fine
        else:
            per_ray = 2 * c.n_coarse + c.n_fine
        cells = int(voxel_feat.shape[1] * voxel_feat.shape[2] * voxel_feat.shape[3])
        return n_rays * per_ray >= cells

    def _late_embed_active(self) -> bool:
        c = self.cfg
        return (c.late_embed and self.field.share_mlp and not c.field.regress_coord
                and not c.field.regress_attention)

    def _eval_points(self, voxel_feat, rays, z_samp, coarse, noise=None,
                     pre_expanded=False, compact=False, generator=None):
        """Field at (rays x z_samp) -> (rgbs (R,K,3), sigmas (R,K), embeds
        (R,K,D), or the relu'd last hidden (R,K,D) with compact)."""
        r, k = z_samp.shape
        pts = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
        dirs = rays[:, None, 3:6].expand(pts.shape)
        out = self.field(voxel_feat, pts.reshape(1, r * k, 3),
                         dirs.reshape(1, r * k, 3), coarse=coarse,
                         expanded=pre_expanded, compact_heads=compact)
        rgbs = out["rgb"].reshape(r, k, 3)
        sigmas = out["sigma"].reshape(r, k)
        embeds = out["hidden" if compact else "embed"].reshape(r, k, -1)
        if self.cfg.noise_std > 0.0:
            if noise is None:
                noise = normal(sigmas.shape, sigmas, generator)
            sigmas = sigmas + noise.to(sigmas) * self.cfg.noise_std
        if self.cfg.field.mask_outside:
            # noise would undo the field's own mask: re-applied here
            b = torch.as_tensor(self.cfg.field.coord_bounds, dtype=pts.dtype,
                                device=pts.device)
            canon = (pts - b[:3]) / (b[3:] - b[:3])
            inb = ((canon >= 0.0) & (canon <= 1.0)).all(dim=-1)
            sigmas = torch.where(inb, sigmas, torch.zeros_like(sigmas))
        return rgbs, sigmas, embeds

    def _project_embed(self, hidden_comp, w_sum):
        """embed_ray = (sum_k w_k h_k) @ K_e + (sum_k w_k) b_e: exact,
        the embed head is linear."""
        mlp = self.field.mlp_coarse
        dt = self.cfg.field.dtype
        k_e = mlp.lin_out_kernel[:, 4:].to(dt)
        return (hidden_comp.to(dt) @ k_e).float() + w_sum[..., None] * mlp.lin_out_bias[4:]

    def _eval_pass(self, voxel_feat, rays, z_samp, coarse, noise=None,
                   pre_expanded=False, compact=False, generator=None):
        rgbs, sigmas, embeds = self._eval_points(voxel_feat, rays, z_samp, coarse, noise,
                                                 pre_expanded, compact, generator)
        out = composite(z_samp, rays, rgbs, sigmas, embeds, white_bkgd=self.cfg.white_bkgd)
        if compact:
            out = out._replace(embed=self._project_embed(out.embed, out.weights.sum(-1)))
        return out

    # ----------------------------------------------------------- occupancy
    @torch.no_grad()
    def prepare(self, voxel_feat=None, occupancy: Optional[torch.Tensor] = None,
                generator=None, u: Optional[torch.Tensor] = None
                ) -> Optional[OccupancyState]:
        """The OccupancyState occ_source asks for ('voxel': the voxelizer's
        occupancy channel; 'field': the field's own sigma; 'auto': their
        union), or None unless sampling_mode='occupancy' (and, with
        occ_require_bounded, unless the field is bounded). u: the field
        probes' jitter draws."""
        if self.cfg.sampling_mode != "occupancy":
            return None
        if self.cfg.occ_require_bounded and not self.cfg.field.mask_outside:
            warnings.warn(
                "occupancy serving requires a bounded-domain field "
                "(field.mask_outside=True): on an unbounded checkpoint the ray "
                "tighten cuts out-of-box density regardless of occ_source — "
                "falling back to stratified sampling. Set "
                "occ_require_bounded=False to force.", stacklevel=2)
            return None
        src = self.cfg.occ_source
        if src == "voxel":
            if occupancy is None:
                raise ValueError("occ_source='voxel' needs the voxelizer occupancy channel")
            return self.prepare_occupancy(occupancy)
        if src == "field":
            return self.prepare_occupancy_from_field(voxel_feat, generator, u)
        if src != "auto":
            raise ValueError(f"unknown occ_source {src!r}")
        fld = self.prepare_occupancy_from_field(voxel_feat, generator, u)
        if occupancy is None:
            return fld
        vox = self.prepare_occupancy(occupancy)
        pooled = torch.maximum(vox.pooled, fld.pooled)
        return OccupancyState(pooled=pooled, aabb=occupied_aabb(pooled))

    def prepare_occupancy(self, occupancy: torch.Tensor) -> OccupancyState:
        """From the voxelizer's occupancy channel, (V,V,V) or (1,V,V,V)."""
        if occupancy.dim() == 4:
            occupancy = occupancy[0]
        pooled = pool_occupancy(occupancy.to(self.device), self.cfg.occ_pool,
                                self.cfg.occ_dilate)
        return OccupancyState(pooled=pooled, aabb=occupied_aabb(pooled))

    @torch.no_grad()
    def prepare_occupancy_from_field(self, voxel_feat, generator=None,
                                     u: Optional[torch.Tensor] = None) -> OccupancyState:
        """Probe the field's sigma at occ_field_probes jittered points in
        each pooled cell, threshold the opacity over one cell-sized step,
        dilate. u: (probes, Vp^3, 3) uniform jitter draws."""
        c = self.cfg
        vp = voxel_feat.shape[1] // c.occ_pool
        p = c.occ_field_probes
        bounds = torch.as_tensor(c.field.coord_bounds, dtype=torch.float32,
                                 device=voxel_feat.device)
        bmin, bmax = bounds[:3], bounds[3:]
        cell = (bmax - bmin) / vp
        ar = (torch.arange(vp, dtype=torch.float32, device=bounds.device) + 0.5) / vp
        gx, gy, gz = torch.meshgrid(ar, ar, ar, indexing="ij")
        centers = bmin + torch.stack([gx, gy, gz], -1).reshape(-1, 3) * (bmax - bmin)
        jit_off = (uniform((p, centers.shape[0], 3), centers, u, generator) - 0.5) * cell
        pts = (centers[None] + jit_off).reshape(1, -1, 3)
        dirs = torch.tensor([0.0, 0.0, -1.0], device=pts.device).expand(pts.shape)
        out = self.field(voxel_feat, pts, dirs, coarse=True)
        sigma = out["sigma"].reshape(p, -1).amax(dim=0)
        occ = (1.0 - torch.exp(-sigma * cell.min())) > c.occ_alpha_thresh
        pooled = max_dilate(occ.reshape(vp, vp, vp).float(), c.occ_dilate)
        pooled = (pooled > 0.0).float()
        return OccupancyState(pooled=pooled, aabb=occupied_aabb(pooled))

    # -------------------------------------------------------------- render
    def render_rays(self, voxel_feat, rays, generator=None, pre_expanded: bool = False,
                    occ: Optional[OccupancyState] = None,
                    draws: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
        """Coarse + fine render of a flat ray batch (R, 8). Returns
        {'coarse': CompositeOut, 'fine': CompositeOut}. draws (optional):
        coarse_u, coarse_jitter (occupancy placement), fine_u, fine_jitter,
        fine_depth_eps, noise_coarse, noise_fine. Differentiable in
        voxel_feat and the field's weights (the serving entry points call it
        under no_grad); the sample positions carry no gradient, as the JAX
        renderer stops it at the samplers' weights and the coarse depth."""
        c = self.cfg
        d = dict(draws or {})
        if not pre_expanded and self._should_expand(rays.shape[0], voxel_feat):
            voxel_feat = expand_corners_to(voxel_feat, c.field.dtype)
            pre_expanded = True
        late = self._late_embed_active()
        occ_mode = c.sampling_mode == "occupancy" and occ is not None
        probe = occ_mode and c.occ_probes > 0
        if occ_mode:
            bounds = torch.as_tensor(c.field.coord_bounds, dtype=rays.dtype,
                                     device=rays.device)
            if c.occ_tighten:
                rays = tighten_rays(rays, occ.aabb, bounds)
            if probe:
                z_coarse = sample_occupancy(rays, occ.pooled, c.n_coarse, bounds,
                                            c.occ_probes, c.occ_floor, u=d.get("coarse_u"),
                                            jitter=d.get("coarse_jitter"),
                                            generator=generator)
            else:
                z_coarse = sample_coarse(rays, c.n_coarse, c.lindisp, u=d.get("coarse_u"),
                                         generator=generator)
        else:
            z_coarse = sample_coarse(rays, c.n_coarse, c.lindisp, u=d.get("coarse_u"),
                                     generator=generator)
        # the proposal sampler's coarse pass is its own small MLP (no
        # compaction)
        compact = late and not c.field.use_proposal
        vals_c = self._eval_points(voxel_feat, rays, z_coarse, True, d.get("noise_coarse"),
                                   pre_expanded, compact, generator)
        coarse = composite(z_coarse, rays, *vals_c, white_bkgd=c.white_bkgd)
        if compact:
            coarse = coarse._replace(embed=self._project_embed(
                coarse.embed, coarse.weights.sum(-1)))
        out = {"coarse": coarse}
        if not c.using_fine:
            return out
        new = []
        if c.n_fine - c.n_fine_depth > 0:
            nf = c.n_fine - c.n_fine_depth
            if probe:
                new.append(sample_importance_z(z_coarse, coarse.weights, nf,
                                               u=d.get("fine_u"), t=d.get("fine_jitter"),
                                               generator=generator))
            else:
                new.append(sample_fine(rays, coarse.weights, nf, c.n_coarse, c.lindisp,
                                       u=d.get("fine_u"), jitter=d.get("fine_jitter"),
                                       generator=generator))
        if c.n_fine_depth > 0:
            new.append(sample_fine_depth(rays, coarse.depth.detach(), c.n_fine_depth,
                                         c.depth_std, eps=d.get("fine_depth_eps"),
                                         generator=generator))
        z_new = torch.cat(new, dim=-1)
        if c.field.use_proposal:
            # the fine output composites only the new samples, through the
            # full field
            z_sorted = torch.sort(z_new, dim=-1).values
            out["fine"] = self._eval_pass(voxel_feat, rays, z_sorted, False,
                                          d.get("noise_fine"), pre_expanded, late, generator)
        elif c.reuse_coarse and self.field.share_mlp:
            # evaluate only the new samples, composite the union without
            # sorting (order-free weights, segment-wise weighted sums)
            vals_n = self._eval_points(voxel_feat, rays, z_new, False, d.get("noise_fine"),
                                       pre_expanded, compact, generator)
            z_all = torch.cat([z_coarse, z_new], dim=-1)
            sig_all = torch.cat([vals_c[1], vals_n[1]], dim=-1)
            w_all = compute_weights_unsorted(z_all, sig_all, rays)
            kc = z_coarse.shape[-1]
            w_c, w_n = w_all[:, :kc], w_all[:, kc:]
            rgb = (w_c[..., None] * vals_c[0]).sum(-2) + (w_n[..., None] * vals_n[0]).sum(-2)
            embed = ((w_c[..., None] * vals_c[2]).sum(-2)
                     + (w_n[..., None] * vals_n[2]).sum(-2))
            if compact:
                embed = self._project_embed(embed, w_all.sum(-1))
            depth = (w_c * z_coarse).sum(-1) + (w_n * z_new).sum(-1)
            if c.white_bkgd:
                rgb = rgb + (1.0 - w_all.sum(1)[..., None])
            out["fine"] = CompositeOut(weights=w_all, rgb=rgb, embed=embed, depth=depth)
        else:
            z_all = torch.sort(torch.cat([z_coarse, z_new], dim=-1), dim=-1).values
            out["fine"] = self._eval_pass(voxel_feat, rays, z_all, False,
                                          d.get("noise_fine"), pre_expanded, late,
                                          generator)
        return out

    def frame_rays(self, tgt_pose, focal, c_principal=None):
        """The (H*W, 8) rays of the frame seen from tgt_pose (1, 4, 4)."""
        cfg = self.cfg
        pose = torch.as_tensor(tgt_pose, dtype=torch.float32).to(self.device)
        return gen_rays(pose, cfg.image_width, cfg.image_height, focal, cfg.z_near,
                        cfg.z_far, c=c_principal).reshape(-1, 8)

    @torch.no_grad()
    def plan_rays(self, occ: OccupancyState, tgt_pose, focal, c_principal=None) -> RayPlan:
        """Active-ray plan of a fixed (scene, camera): rays whose tightened
        interval is non-empty, padded to a whole number of tiles. One host
        round trip, at serving setup. A culled ray composites as pure
        background, which on a mask_outside field is exactly what the
        unculled occupancy render gives it."""
        cfg = self.cfg
        rays = self.frame_rays(tgt_pose, focal, c_principal)
        bounds = torch.as_tensor(cfg.field.coord_bounds, dtype=rays.dtype,
                                 device=rays.device)
        t = tighten_rays(rays, occ.aabb, bounds)
        idx = torch.nonzero(t[:, 7] > t[:, 6])[:, 0].cpu().numpy()
        n = rays.shape[0]
        n_active = int(idx.size)
        tile = min(cfg.render_tile, max(n_active, 1))
        cap = max(((n_active + tile - 1) // tile) * tile, tile)
        idx_p = np.full((cap,), n, np.int64)
        idx_p[:n_active] = idx
        return RayPlan(idx=torch.from_numpy(idx_p).to(self.device), n_active=n_active,
                       n_total=n)

    @torch.no_grad()
    def render_image(self, voxel_feat, tgt_pose, focal, generator=None,
                     c_principal=None, occ: Optional[OccupancyState] = None,
                     plan: Optional[RayPlan] = None,
                     draws: Optional[List[Mapping[str, torch.Tensor]]] = None):
        """Render the (H, W) frame in tiles of render_tile rays. tgt_pose:
        (1, 4, 4). Returns (rgb (H,W,3), embed (H,W,D), depth (H,W)). With a
        RayPlan only the active rays are rendered and the rest of the frame
        is background. draws: one render_rays draws mapping per tile."""
        cfg = self.cfg
        h, w = cfg.image_height, cfg.image_width
        rays = self.frame_rays(tgt_pose, focal, c_principal)
        expanded = self._should_expand(rays.shape[0], voxel_feat)
        if expanded:
            with torch.profiler.record_function("expand_corners"):
                voxel_feat = expand_corners_to(voxel_feat, cfg.field.dtype)
        n = rays.shape[0]
        if plan is not None:
            rays_sel = rays[plan.idx.clamp(max=n - 1)]
            tile = min(cfg.render_tile, rays_sel.shape[0])
            tiles = rays_sel.reshape(-1, tile, 8)
        else:
            tile = min(cfg.render_tile, n)
            n_pad = (-n) % tile
            pad = torch.zeros((n_pad, 8), dtype=rays.dtype, device=rays.device)
            pad[:, 6], pad[:, 7] = cfg.z_near, cfg.z_far
            tiles = torch.cat([rays, pad]).reshape(-1, tile, 8)
        if draws is not None and len(draws) != tiles.shape[0]:
            raise ValueError(f"{len(draws)} draws for {tiles.shape[0]} tiles")
        rgbs, embeds, depths = [], [], []
        for i in range(tiles.shape[0]):
            o = self.render_rays(voxel_feat, tiles[i], generator, pre_expanded=expanded,
                                 occ=occ, draws=None if draws is None else draws[i])
            f = o.get("fine", o["coarse"])
            rgbs.append(f.rgb)
            embeds.append(f.embed)
            depths.append(f.depth)
        rgb, embed, depth = torch.cat(rgbs), torch.cat(embeds), torch.cat(depths)
        if plan is not None:
            bg = 1.0 if cfg.white_bkgd else 0.0
            full_rgb = torch.full((n + 1, 3), bg, dtype=rgb.dtype, device=rgb.device)
            full_embed = torch.zeros((n + 1, embed.shape[-1]), dtype=embed.dtype,
                                     device=embed.device)
            full_depth = torch.zeros((n + 1,), dtype=depth.dtype, device=depth.device)
            full_rgb[plan.idx] = rgb          # pads land on row n, dropped
            full_embed[plan.idx] = embed
            full_depth[plan.idx] = depth
            rgb, embed, depth = full_rgb, full_embed, full_depth
        return (rgb[:n].reshape(h, w, 3), embed[:n].reshape(h, w, -1),
                depth[:n].reshape(h, w))

    # ---------------------------------------------------------------- loss
    def rendering_loss(self, voxel_feat, gt_rgb, gt_pose, focal, generator=None,
                       gt_embed=None, gt_depth=None, c_principal=None,
                       occ: Optional[OccupancyState] = None,
                       ray_idx: Optional[torch.Tensor] = None,
                       draws: Optional[Mapping[str, torch.Tensor]] = None,
                       depth_denominator=None):
        """Sampled-ray rendering loss of one view (the JAX package's
        `rendering_loss`): ray_chunk_size rays of the (1, H, W) view, the
        coarse and fine rgb MSE, lambda_embed times the embed MSE of both
        passes against gt_embed (1, H, W, D), and lambda_depth times the
        masked depth MSE of both against gt_depth (1, H, W) where
        gt_depth < z_far. gt_rgb (1, H, W, 3) in [0, 1], gt_pose (1, 4, 4).
        ray_idx (ray_chunk_size,) picks the rays (else drawn uniformly from
        `generator`); draws go to render_rays. depth_denominator maps the
        count of depth-masked rays to the depth terms' denominator (default
        max(count, 1); a ray-parallel step passes the global one). Returns
        (loss, metrics)."""
        cfg = self.cfg
        h, w = cfg.image_height, cfg.image_width
        rays = gen_rays(gt_pose, w, h, focal, cfg.z_near, cfg.z_far,
                        c=c_principal).reshape(-1, 8)
        if ray_idx is None:
            gen_dev = generator.device if generator is not None else "cpu"
            ray_idx = torch.randint(0, h * w, (cfg.ray_chunk_size,), generator=generator,
                                    device=gen_dev)
        ray_idx = ray_idx.to(rays.device).long()
        out = self.render_rays(voxel_feat, rays[ray_idx], generator, occ=occ, draws=draws)
        gt_rgb_sel = gt_rgb.reshape(-1, 3)[ray_idx]
        coarse, fine = out["coarse"], out.get("fine", out["coarse"])
        loss_rgb_c = torch.mean((coarse.rgb - gt_rgb_sel) ** 2)
        loss_rgb_f = torch.mean((fine.rgb - gt_rgb_sel) ** 2)
        loss = loss_rgb_c + loss_rgb_f
        metrics = {"loss_rgb_coarse": loss_rgb_c, "loss_rgb_fine": loss_rgb_f,
                   "psnr": psnr(fine.rgb, gt_rgb_sel)}
        if gt_embed is not None:
            gt_e = gt_embed.reshape(-1, gt_embed.shape[-1])[ray_idx]
            loss_e_f = cfg.lambda_embed * torch.mean((fine.embed - gt_e) ** 2)
            loss = loss + loss_e_f
            metrics["loss_embed_fine"] = loss_e_f
            if not cfg.field.use_proposal:   # the proposal pass has no embed
                loss_e_c = cfg.lambda_embed * torch.mean((coarse.embed - gt_e) ** 2)
                loss = loss + loss_e_c
                metrics["loss_embed_coarse"] = loss_e_c
        if gt_depth is not None and cfg.lambda_depth > 0:
            gt_d = gt_depth.reshape(-1)[ray_idx]
            mask = (gt_d < cfg.z_far).to(gt_d.dtype)
            denom = (torch.clamp(mask.sum(), min=1.0) if depth_denominator is None
                     else depth_denominator(mask.sum()))
            loss_d_c = cfg.lambda_depth * torch.sum(mask * (coarse.depth - gt_d) ** 2) / denom
            loss_d_f = cfg.lambda_depth * torch.sum(mask * (fine.depth - gt_d) ** 2) / denom
            loss = loss + loss_d_c + loss_d_f
            metrics["loss_depth_coarse"] = loss_d_c
            metrics["loss_depth_fine"] = loss_d_f
        metrics["loss_render"] = loss
        return loss, metrics
