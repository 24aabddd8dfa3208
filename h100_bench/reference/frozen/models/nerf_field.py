"""Voxel-conditioned NeRF field (counterpart of the JAX package's
`models/nerf_field.py`).

Per query point: world xyz -> canonical [0,1]^3 -> trilinear sample of the
policy's voxel feature grid (the latent); canonical xyz -> positional code
(6 freqs, factor 1.5, with input: 39 dims) + raw viewdirs (3); [latent,
code, viewdirs] -> ResnetFC -> [sigmoid(rgb), relu(sigma), embed].

With `use_proposal`, a small ResnetFC (`mlp_proposal`: d_out 4,
proposal_blocks x proposal_hidden, no combine) replaces the full field on
the coarse pass: [sigmoid(rgb), masked relu(sigma), a zero embed]; with
`proposal_use_latent` false it sees only the code and viewdirs, and the
coarse samples skip the voxel gather. The port's `quantized` field and
its kernel backends are left out of this frozen copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from h100_bench.reference.frozen.models.resnetfc import ResnetFC
from h100_bench.reference.frozen.ops.grid_sample import sample_in_canonical_voxel
from h100_bench.reference.frozen.ops.rays import (
    PositionalEncodingSpec, positional_encoding)


@dataclasses.dataclass(frozen=True)
class NerfFieldConfig:
    """Same fields and meanings as the JAX NerfFieldConfig. Of mlp_backend
    the frozen renderer takes "xla" (the plain field) alone."""
    d_latent: int = 64
    d_embed: int = 512
    d_hidden: int = 512
    n_blocks: int = 5
    combine_layer: int = 3
    use_viewdirs: bool = True
    use_code: bool = True
    num_freqs: int = 6
    freq_factor: float = 1.5
    regress_coord: bool = False
    regress_attention: bool = False
    coord_bounds: Tuple[float, ...] = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
    compute_dtype: str = "float32"
    use_proposal: bool = False
    proposal_hidden: int = 128
    proposal_blocks: int = 2
    proposal_use_latent: bool = True
    quantized: bool = False
    mlp_backend: str = "xla"  # "xla" | "pallas_int8" | "pallas_bf16"
    int8_static_act: bool = False
    gather_fused_mlp: bool = False
    mask_outside: bool = False

    @property
    def d_in(self) -> int:
        d = 3
        if self.use_code:
            d = PositionalEncodingSpec(self.num_freqs, 3, self.freq_factor, True).d_out
        if self.use_viewdirs:
            d += 3
        return d

    @property
    def d_out(self) -> int:
        d = 4 + self.d_embed
        if self.regress_coord:
            d += 3
        if self.regress_attention:
            d += 6
        return d

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


class VoxelNerfField(nn.Module):
    def __init__(self, cfg: NerfFieldConfig, share_mlp: bool = True):
        super().__init__()
        if cfg.quantized:
            raise ValueError("the reference runs the field unquantized")
        self.cfg, self.share_mlp = cfg, share_mlp
        kw = dict(d_in=cfg.d_in, d_out=cfg.d_out, n_blocks=cfg.n_blocks,
                  d_latent=cfg.d_latent, d_hidden=cfg.d_hidden,
                  combine_layer=cfg.combine_layer, dtype=cfg.dtype)
        self.mlp_coarse = ResnetFC(**kw)
        if not share_mlp:
            self.mlp_fine = ResnetFC(**kw)
        if cfg.use_proposal:
            self.mlp_proposal = ResnetFC(
                d_in=cfg.d_in, d_out=4, n_blocks=cfg.proposal_blocks,
                d_latent=cfg.d_latent if cfg.proposal_use_latent else 0,
                d_hidden=cfg.proposal_hidden, combine_layer=1000, dtype=cfg.dtype)

    def world_to_canonical(self, xyz: torch.Tensor) -> torch.Tensor:
        b = torch.as_tensor(self.cfg.coord_bounds, dtype=xyz.dtype, device=xyz.device)
        return (xyz - b[:3]) / (b[3:] - b[:3])

    def forward(self, voxel_feat: torch.Tensor, xyz: torch.Tensor,
                viewdirs: Optional[torch.Tensor] = None, coarse: bool = True,
                ret_last_feat: bool = False, expanded: bool = False,
                compact_heads: bool = False) -> dict:
        """voxel_feat: (SB, V, V, V, d_latent), or its corner-expanded form
        when expanded; xyz, viewdirs: (SB, B, 3). Returns rgb (SB, B, 3),
        sigma (SB, B) and embed (SB, B, d_embed) (or, with compact_heads,
        hidden (SB, B, d_hidden): the relu'd last hidden)."""
        c = self.cfg
        sb, b, _ = xyz.shape
        canon = self.world_to_canonical(xyz).detach()
        if c.mask_outside:
            inb = ((canon >= 0.0) & (canon <= 1.0)).all(dim=-1)

            def mask(s):
                return torch.where(inb, s, torch.zeros_like(s))
        else:
            def mask(s):
                return s
        feat = canon
        if c.use_code:
            feat = positional_encoding(canon, PositionalEncodingSpec(
                c.num_freqs, 3, c.freq_factor, True))
        if c.use_viewdirs:
            feat = torch.cat([feat, viewdirs.to(feat.dtype)], dim=-1)
        proposal_pass = coarse and c.use_proposal
        if proposal_pass and not c.proposal_use_latent:
            mlp_in = feat.reshape(sb * b, -1)
        else:
            latent = sample_in_canonical_voxel(voxel_feat, canon, expanded=expanded,
                                               out_channels=c.d_latent)
            dt = torch.promote_types(latent.dtype, feat.dtype)
            mlp_in = torch.cat([latent.to(dt), feat.to(dt)], dim=-1).reshape(sb * b, -1)
        if proposal_pass:
            out = self.mlp_proposal(mlp_in)[0].reshape(sb, b, 4)
            return {"rgb": torch.sigmoid(out[..., :3].float()),
                    "sigma": mask(torch.relu(out[..., 3].float())),
                    "embed": torch.zeros((sb, b, c.d_embed), dtype=out.dtype,
                                         device=out.device)}
        mlp = self.mlp_coarse if (coarse or self.share_mlp) else self.mlp_fine
        if compact_heads:
            if c.regress_coord or c.regress_attention:
                raise ValueError("compact_heads supports the rgb/sigma/embed heads")
            out, last = mlp(mlp_in, head_dims=4)
            out = out.reshape(sb, b, 4)
            return {"rgb": torch.sigmoid(out[..., :3].float()),
                    "sigma": mask(torch.relu(out[..., 3].float())),
                    "hidden": torch.relu(last).reshape(sb, b, -1)}
        out, last = mlp(mlp_in)
        out = out.reshape(sb, b, c.d_out)
        res = {"rgb": torch.sigmoid(out[..., :3].float()),
               "sigma": mask(torch.relu(out[..., 3].float()))}
        rest = out[..., 4:]
        if c.regress_coord and c.regress_attention:
            res["embed"] = rest[..., :-9]
            res["coord_residual"] = rest[..., -9:-6] - canon
            res["attention"] = rest[..., -6:]
        elif c.regress_coord:
            res["embed"] = rest[..., :-3]
            res["coord_residual"] = rest[..., -3:] - canon
        elif c.regress_attention:
            res["embed"] = rest[..., :-6]
            res["attention"] = rest[..., -6:]
        else:
            res["embed"] = rest
        if ret_last_feat:
            res["last_feat"] = last.reshape(sb, b, -1)
        return res
