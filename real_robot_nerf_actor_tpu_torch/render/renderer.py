"""Neural volume renderer over a voxel feature field: the serving renderer
of `configs/serve.yaml` (counterpart of the JAX package's
`render/renderer.py`).

Lifecycle of fixed-camera serving:
  1. `prepare`             occupancy state for sampling_mode="occupancy"
                           (voxelizer channel, field probes, or their union);
  2. `calibrate_int8_act`  static int8 activation scales (int8_static_act);
  3. `plan_rays`           RayPlan: the frame's rays that hit the occupied
                           box, padded to whole tiles;
  4. `render_image`        the frame, in tiles of `render_tile` rays, each a
                           coarse + fine `render_rays` pass.

With field.mlp_backend "pallas_int8" / "pallas_bf16" every tile runs, per
pass, `ray_expand` (CUDA), then either the row gather + `corner_lerp`
(CUDA) + `fused_resnetfc_int8` (CUDA), or, with field.gather_fused_mlp,
`fused_gather_resnetfc_int8` (CUDA), which gathers and lerps itself.
mlp_backend "xla" runs the plain field. The field's weights live in
`self.field` (convert.py maps a flax tree onto it); the kernels' packed
copy is built once, by `load_field` (or `init_params`).

With field.use_proposal the coarse pass runs the field's small proposal
MLP on the plain path, and the fine pass composites only the sorted new
samples through the full field (kernels where the knobs are on);
`rendering_loss` then has no coarse embed term.

Training (the NeRF-Actor joint step) calls `rendering_loss`, whose
`render_rays` builds the autograd graph through the plain field, or, on the
corner-expanded grid with `ops.grid_sample.FUSED_LERP_BACKEND = "pallas"`,
through the `corner_lerp` kernel and its VJP. The int8 serving kernels
refuse grad (`ops/_grad.py`).

Spans (`utils/profiling.named_scope`, recorded only while a profiler
records or `collect()` is open): `render.frame` around `render_image`, in
it `render.rays` (frame rays, `expand_corners`, plan gather, tiling), one
`render.tile` a tile and `render.scatter` (the tiles joined into the
frame); in each `render_rays` `render.sample` (tighten, coarse or
occupancy sampling), `render.field` (each `_eval_points`, coarse and
fine), `render.composite` and `render.resample` (fine sampling).

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

from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models.nerf_field import (
    NerfFieldConfig, VoxelNerfField)
from real_robot_nerf_actor_tpu_torch.ops.compositing import (
    CompositeOut, composite, compute_weights_unsorted)
from real_robot_nerf_actor_tpu_torch.ops.grid_sample import expand_corners_to
from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
from real_robot_nerf_actor_tpu_torch.ops.occupancy import (
    max_dilate, occupied_aabb, pool_occupancy, sample_occupancy, tighten_rays)
from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import BN, ray_expand
from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays
from real_robot_nerf_actor_tpu_torch.ops.resnetfc_cuda import (
    capture_act_amax, fused_gather_resnetfc_int8, fused_resnetfc_int8,
    pack_resnetfc_params, static_act_scales)
from real_robot_nerf_actor_tpu_torch.ops.sampling import (
    normal, sample_coarse, sample_fine, sample_fine_depth, sample_importance_z, uniform)
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


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
        self.field = VoxelNerfField(cfg.field).to(self.device)
        self._packed = None
        self._int8_act_scales = None     # host floats
        self._act_scales_t = None        # (2, 2 n_blocks) [xs; inv] on the device

    # ------------------------------------------------------------- weights
    def init_params(self, generator: Optional[torch.Generator] = None) -> "NeuralRenderer":
        """Random weights drawn as flax initialises the field."""
        init_weights(self.field, generator)
        self._pack()
        return self

    def load_field(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load the field's weights (the port's layout; convert.py maps a
        flax tree) and pack them for the kernels."""
        self.field.load_state_dict(state_dict)
        self.field.to(self.device)
        self._pack()

    def _pack(self) -> None:
        """The serving kernels' copy of the weights, packed once per set of
        weights ("pallas_int8": int8 blocks, "pallas_bf16": bf16)."""
        c = self.cfg.field
        self._packed = None
        if c.mlp_backend in ("pallas_int8", "pallas_bf16"):
            with torch.no_grad():
                self._packed = pack_resnetfc_params(
                    self.field.mlp_coarse.state_dict(), d_latent=c.d_latent,
                    num_freqs=c.num_freqs, d_hidden=c.d_hidden, n_blocks=c.n_blocks,
                    combine_layer=c.combine_layer,
                    quantize=c.mlp_backend == "pallas_int8")

    # ---------------------------------------------------------------- core
    def _should_expand(self, n_rays: int, voxel_feat) -> bool:
        fg = self.cfg.fused_gather
        if fg != "auto":
            return bool(fg)
        c = self.cfg
        if c.field.mlp_backend in ("pallas_int8", "pallas_bf16") and self._late_embed_active():
            return True
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

    def _fused_int8_active(self, compact: bool) -> bool:
        return (self.cfg.field.mlp_backend in ("pallas_int8", "pallas_bf16")
                and compact and self.field.share_mlp)

    def _late_embed_active(self) -> bool:
        c = self.cfg
        return (c.late_embed and self.field.share_mlp and not c.field.regress_coord
                and not c.field.regress_attention)

    def _eval_points(self, voxel_feat, rays, z_samp, coarse, noise=None,
                     pre_expanded=False, compact=False, generator=None):
        """Field at (rays x z_samp) -> (rgbs (R,K,3), sigmas (R,K), embeds
        (R,K,D), or the relu'd last hidden (K,R,D) on the kernel path)."""
        with named_scope("render.field"):
            r, k = z_samp.shape
            pts = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
            if self._fused_int8_active(compact) and pre_expanded:
                rgbs, sigmas, embeds = self._eval_points_fused_int8(voxel_feat, rays, z_samp)
            else:
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
                # the kernels bypass the field's own mask, and noise would undo
                # it on the plain path: re-applied here
                b = torch.as_tensor(self.cfg.field.coord_bounds, dtype=pts.dtype,
                                    device=pts.device)
                canon = (pts - b[:3]) / (b[3:] - b[:3])
                inb = ((canon >= 0.0) & (canon <= 1.0)).all(dim=-1)
                sigmas = torch.where(inb, sigmas, torch.zeros_like(sigmas))
            return rgbs, sigmas, embeds

    def _expand_rays_int8(self, voxel_feat, rays, z_samp):
        """ray_expand over (rays x z_samp), rays padded to a multiple of its
        block (BN) by repeating ray 0. Returns (auxT (24, N), w8T (8, N),
        flatT (N,), r, rp, k), N = k * rp, sample order K-major."""
        c = self.cfg.field
        if not (c.use_code and c.use_viewdirs):
            raise ValueError("the fused int8 path covers the positional code + "
                             "viewdirs input layout")
        r, k = z_samp.shape
        pad_r = (-r) % BN
        if pad_r:
            rays = torch.cat([rays, rays[:1].expand(pad_r, rays.shape[1])])
            z_samp = torch.cat([z_samp, z_samp[:1].expand(pad_r, k)])
        rp = r + pad_r
        _, dp, hp, wp, _ = voxel_feat.shape
        auxT, w8T, flatT = ray_expand(rays.contiguous(), z_samp.contiguous(),
                                      (dp - 1, hp - 1, wp - 1), c.coord_bounds,
                                      c.num_freqs, c.freq_factor)
        n = k * rp
        return auxT.reshape(auxT.shape[0], n), w8T.reshape(8, n), flatT.reshape(n), r, rp, k

    def _assemble_zi_int8(self, voxel_feat, rays, z_samp):
        """The fused kernel's packed (N, 128) bf16 input rows: row gather,
        corner_lerp, [latent | aux | 0]. Shared by serving and calibration,
        so the calibrated scales see the rows the kernel quantizes.
        Returns (zi, r, rp, k)."""
        auxT, w8T, flatT, r, rp, k = self._expand_rays_int8(voxel_feat, rays, z_samp)
        n = flatT.shape[0]
        c8 = voxel_feat.shape[-1]
        rows = voxel_feat.reshape(-1, c8)[flatT.long()]
        latent = corner_lerp(rows, w8T)
        width = self.cfg.field.d_latent + auxT.shape[0]
        zi = torch.cat([latent.to(torch.bfloat16), auxT.T,
                        torch.zeros((n, 128 - width), dtype=torch.bfloat16,
                                    device=latent.device)], dim=-1)
        return zi, r, rp, k

    @torch.no_grad()
    def calibrate_int8_act(self, voxel_feat, rays, generator=None, n_rays: int = 512,
                           margin: float = 1.05, subset: Optional[torch.Tensor] = None,
                           u: Optional[torch.Tensor] = None):
        """Static int8 activation scales for field.int8_static_act, once per
        scene/checkpoint: stratified z over a subset of the serving rays,
        the kernel's exact zi rows, each block matmul's input abs-max.
        Scales are margin * amax / 127 + 1e-8 (host floats, returned) and a
        device tensor the kernels take as an argument. subset: (n_rays,) ray
        indices (else a random choice without replacement); u: the
        stratified draws (n_rays, n_coarse + n_fine)."""
        c = self.cfg.field
        if voxel_feat.shape[-1] == c.d_latent:   # accept the raw grid too
            voxel_feat = expand_corners_to(voxel_feat, c.dtype)
        if rays.shape[0] > n_rays:
            if subset is None:
                subset = torch.randperm(rays.shape[0], generator=generator,
                                        device=rays.device)[:n_rays]
            rays = rays[subset.to(rays.device)]
        z = sample_coarse(rays, self.cfg.n_coarse + self.cfg.n_fine, self.cfg.lindisp,
                          u=u, generator=generator)
        zi = self._assemble_zi_int8(voxel_feat, rays, z)[0]
        packed = pack_resnetfc_params(
            self.field.mlp_coarse.state_dict(), d_latent=c.d_latent,
            num_freqs=c.num_freqs, d_hidden=c.d_hidden, n_blocks=c.n_blocks,
            combine_layer=c.combine_layer, quantize=False)
        amax = capture_act_amax(zi, packed, n_blocks=c.n_blocks,
                                combine_layer=c.combine_layer)
        self._int8_act_scales = tuple(float(a) * margin / 127.0 + 1e-8
                                      for a in amax.tolist())
        self._act_scales_t = static_act_scales(self._int8_act_scales, zi.device)
        return self._int8_act_scales

    def _eval_points_fused_int8(self, voxel_feat, rays, z_samp):
        """Serving path on the corner-expanded grid: ray_expand, then the
        gather + corner_lerp + fused MLP chain, or the gather-fused kernel.
        Sample order is K-major: rgb/sigma come back (R, K), the hidden
        stays (K, R, D) for the compositing contraction."""
        c = self.cfg.field
        quantized = c.mlp_backend == "pallas_int8"
        scales = None
        if quantized and c.int8_static_act:
            if self._act_scales_t is None:
                raise RuntimeError("field.int8_static_act=True: call "
                                   "calibrate_int8_act() once per scene before rendering")
            scales = self._act_scales_t
        packed = self._packed
        if packed is None:
            raise RuntimeError("no field weights: call load_field() or init_params()")
        if c.gather_fused_mlp:
            auxT, w8T, flatT, r, rp, k = self._expand_rays_int8(voxel_feat, rays, z_samp)
            out, hidden = fused_gather_resnetfc_int8(
                voxel_feat.reshape(-1, voxel_feat.shape[-1]), flatT, w8T, auxT, packed,
                d_latent=c.d_latent, num_freqs=c.num_freqs, n_blocks=c.n_blocks,
                combine_layer=c.combine_layer, quantized=quantized, act_scales=scales)
        else:
            zi, r, rp, k = self._assemble_zi_int8(voxel_feat, rays, z_samp)
            out, hidden = fused_resnetfc_int8(zi, packed, c.n_blocks, c.combine_layer,
                                              quantized=quantized, act_scales=scales)
        out = out.reshape(k, rp, 128)[:, :r]
        rgb = torch.sigmoid(out[..., :3].float()).permute(1, 0, 2)
        sigma = torch.relu(out[..., 3].float()).T
        hidden = hidden.reshape(k, rp, -1)[:, :r]
        return rgb, sigma, hidden

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
        with named_scope("render.composite"):
            out = composite(z_samp, rays, rgbs, sigmas, embeds, white_bkgd=self.cfg.white_bkgd,
                            embeds_kmajor=self._fused_int8_active(compact) and pre_expanded)
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
        with named_scope("render.sample"):
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
                    z_coarse = sample_coarse(rays, c.n_coarse, c.lindisp,
                                             u=d.get("coarse_u"), generator=generator)
            else:
                z_coarse = sample_coarse(rays, c.n_coarse, c.lindisp, u=d.get("coarse_u"),
                                         generator=generator)
        # the proposal sampler's coarse pass is its own small MLP on the plain
        # path (no compaction); only the fine pass reaches the kernels
        compact = late and not c.field.use_proposal
        vals_c = self._eval_points(voxel_feat, rays, z_coarse, True, d.get("noise_coarse"),
                                   pre_expanded, compact, generator)
        kmajor = self._fused_int8_active(compact) and pre_expanded
        with named_scope("render.composite"):
            coarse = composite(z_coarse, rays, *vals_c, white_bkgd=c.white_bkgd,
                               embeds_kmajor=kmajor)
            if compact:
                coarse = coarse._replace(embed=self._project_embed(
                    coarse.embed, coarse.weights.sum(-1)))
        out = {"coarse": coarse}
        if not c.using_fine:
            return out
        with named_scope("render.resample"):
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
            # the fine pass's samples: the new ones sorted (proposal), the
            # new ones (coarse reused) or the union sorted
            if c.field.use_proposal:
                z_fine = torch.sort(z_new, dim=-1).values
            elif c.reuse_coarse and self.field.share_mlp:
                z_fine = z_new
            else:
                z_fine = torch.sort(torch.cat([z_coarse, z_new], dim=-1), dim=-1).values
        if c.field.use_proposal:
            # the fine output composites only the new samples, through the
            # full field
            out["fine"] = self._eval_pass(voxel_feat, rays, z_fine, False,
                                          d.get("noise_fine"), pre_expanded, late, generator)
        elif c.reuse_coarse and self.field.share_mlp:
            # evaluate only the new samples, composite the union without
            # sorting (order-free weights, segment-wise weighted sums)
            vals_n = self._eval_points(voxel_feat, rays, z_fine, False, d.get("noise_fine"),
                                       pre_expanded, compact, generator)
            with named_scope("render.composite"):
                z_all = torch.cat([z_coarse, z_new], dim=-1)
                sig_all = torch.cat([vals_c[1], vals_n[1]], dim=-1)
                w_all = compute_weights_unsorted(z_all, sig_all, rays)
                kc = z_coarse.shape[-1]
                w_c, w_n = w_all[:, :kc], w_all[:, kc:]
                rgb = ((w_c[..., None] * vals_c[0]).sum(-2)
                       + (w_n[..., None] * vals_n[0]).sum(-2))
                if kmajor:
                    embed = (torch.einsum("bk,kbd->bd", w_c, vals_c[2].float())
                             + torch.einsum("bk,kbd->bd", w_n, vals_n[2].float()))
                else:
                    embed = ((w_c[..., None] * vals_c[2]).sum(-2)
                             + (w_n[..., None] * vals_n[2]).sum(-2))
                if compact:
                    embed = self._project_embed(embed, w_all.sum(-1))
                depth = (w_c * z_coarse).sum(-1) + (w_n * z_new).sum(-1)
                if c.white_bkgd:
                    rgb = rgb + (1.0 - w_all.sum(1)[..., None])
                out["fine"] = CompositeOut(weights=w_all, rgb=rgb, embed=embed, depth=depth)
        else:
            out["fine"] = self._eval_pass(voxel_feat, rays, z_fine, False,
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
        with named_scope("render.frame"):
            with named_scope("render.rays"):
                rays = self.frame_rays(tgt_pose, focal, c_principal)
                expanded = self._should_expand(rays.shape[0], voxel_feat)
                if expanded:
                    with named_scope("expand_corners"):
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
                with named_scope("render.tile"):
                    o = self.render_rays(voxel_feat, tiles[i], generator,
                                         pre_expanded=expanded, occ=occ,
                                         draws=None if draws is None else draws[i])
                    f = o.get("fine", o["coarse"])
                    rgbs.append(f.rgb)
                    embeds.append(f.embed)
                    depths.append(f.depth)
            with named_scope("render.scatter"):
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
