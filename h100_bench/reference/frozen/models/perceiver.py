"""PerceiverIO language-conditioned voxel Q-network (counterpart of the JAX
package's `models/perceiver.py`).

  voxel grid (B, V^3, 10ch channel-last)
    -> 1x1x1 conv ("conv1") or 3-level UNet ("unet") -> d0 (64 ch)
    -> patchify (V/P)^3 -> + proprio embedding -> 77 language tokens
       + (V/P)^3 voxel tokens + learned positions
    -> cross-attention into the latents, depth x self-attention,
       decoder cross-attention back to the tokens
    -> transposed-conv upsample, skip-concat with d0, `final` k3 conv,
       trans head (B, V^3) and the rot/grip/collision MLP head.

The port's three kernel knobs (use_flash_attention, conv_backend
"pallas", stats_backend "pallas") are left out of this frozen copy, which
runs the plain attention, conv and spatial softmax and refuses the knobs.
`dropout_rate` builds the same layers as flax (attention dropout has no
parameters). Dropout acts only with deterministic=False, which
no caller of either package passes: in every mode they use the network is
the dropout-free one.
Numerics follow flax: LayerNorm eps 1e-6, tanh-approximate GELU, the UNet
and head Dense layers in fp32, attention/FF outputs cast to fp32.
Module and parameter names mirror the flax tree.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.frozen.models.blocks import (
    ContractFirstConv3D, Conv3DBlock, Conv3DUpsampleBlock, Dense, DenseBlock,
    MultiLayer3DEncoderShallow, PatchifyConv3D, init_weights)
from h100_bench.reference.frozen.ops.attention import reference_attention
from h100_bench.reference.frozen.ops.spatial_softmax import spatial_softmax_3d

_LN_EPS = 1e-6   # flax nn.LayerNorm's default


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or wider: the casts the JAX model makes to fp32 leave a
    float64 network (compute_dtype "float64", weights .double()) in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    """Same fields and meanings as the JAX PerceiverConfig, so one YAML
    drives both packages. The TPU-only lowering knobs
    (`upsample_conv_backend`, the "conv2d"/"conv2d_packed" conv backends)
    are accepted and compute the plain conv."""
    depth: int = 6
    voxel_size: int = 100
    initial_dim: int = 10
    low_dim_size: int = 7
    num_rotation_classes: int = 72
    num_grip_classes: int = 2
    num_collision_classes: int = 2
    num_latents: int = 2048
    latent_dim: int = 512
    im_channels: int = 64
    cross_heads: int = 1
    latent_heads: int = 8
    cross_dim_head: int = 64
    latent_dim_head: int = 64
    voxel_patch_size: int = 5
    final_dim: int = 64
    lang_emb_dim: int = 512
    lang_max_seq_len: int = 77
    activation: str = "lrelu"
    input_encoder: str = "conv1"     # "conv1" (peract) | "unet" (nerfact)
    return_voxel_feat: bool = False
    dropout_rate: float = 0.0
    compute_dtype: str = "float32"   # "float32" | "bfloat16" | "float64"
    use_flash_attention: bool = False
    upsample_mode: str = "transpose"
    conv_padding: str = "zeros"
    conv_backend: str = "conv2d"
    upsample_conv_backend: str = "xla"
    stats_backend: str = "xla"
    aux_trans_head: bool = False
    grip_proprio_scale: float = 1.0

    @property
    def spatial_size(self) -> int:
        return self.voxel_size // self.voxel_patch_size

    @property
    def input_dim_before_seq(self) -> int:
        return self.im_channels * 2

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}[self.compute_dtype]


class MHAttention(nn.Module):
    """Multi-head attention; q from query_dim, k/v from context_dim, output
    projected back to out_dim and cast to fp32, in the JAX einsum form (`reference_attention`: fp32 scores and softmax,
    probabilities in v's dtype)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, out_dim: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout_rate = heads, dim_head, dropout_rate
        self.to_q = Dense(query_dim, inner, use_bias=False, dtype=dtype)
        self.to_kv = Dense(context_dim, inner * 2, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, out_dim, dtype=dtype)

    def forward(self, x, context=None, deterministic: bool = True):
        context = x if context is None else context
        q = self.to_q(x)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        heads = q.shape[-1] // self.dim_head   # a model rank's, when cut (parallel/)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, heads, self.dim_head).transpose(1, 2)

        q, k, v = map(split_heads, (q, k, v))
        if self.dropout_rate > 0 and not deterministic:
            s = torch.einsum("bhid,bhjd->bhij", widen(q), widen(k)) * self.dim_head ** -0.5
            p = F.dropout(torch.softmax(s, dim=-1).to(v.dtype), self.dropout_rate)
            out = torch.einsum("bhij,bhjd->bhid", p, v)
            out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        else:
            out = reference_attention(q, k, v)
            out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return widen(self.to_out(out))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, mult: int = 4):
        super().__init__()
        self.Dense_0 = Dense(dim, dim * mult * 2, dtype=dtype)
        self.Dense_1 = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        h, gates = self.Dense_0(x).chunk(2, dim=-1)
        return widen(self.Dense_1(h * F.gelu(gates, approximate="tanh")))


class PreNormAttn(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, out_dim: int, dtype: torch.dtype,
                 cross: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(query_dim, eps=_LN_EPS)
        self.norm_context = (nn.LayerNorm(context_dim, eps=_LN_EPS)
                             if cross else None)
        self.MHAttention_0 = MHAttention(query_dim, context_dim, heads,
                                         dim_head, out_dim, dtype, dropout_rate)

    def forward(self, x, context=None, deterministic: bool = True):
        cn = self.norm_context(context) if self.norm_context is not None else None
        return self.MHAttention_0(self.LayerNorm_0(x), cn, deterministic)


class PreNormFF(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.GEGLUFeedForward_0 = GEGLUFeedForward(dim, dtype)

    def forward(self, x):
        return self.GEGLUFeedForward_0(self.LayerNorm_0(x))


class PerceiverIO(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = cfg.dtype
        head = torch.promote_types(dt, torch.float32)   # the fp32 heads; float64 in float64
        s = cfg.spatial_size
        seq_dim = cfg.input_dim_before_seq
        if c.input_encoder == "unet":
            self.encoder_3d = MultiLayer3DEncoderShallow(c.initial_dim, c.im_channels)
        else:
            self.input_preprocess = Conv3DBlock(
                c.initial_dim, c.im_channels, 1, 1, c.activation, dtype=dt,
                padding=c.conv_padding)
        self.patchify = PatchifyConv3D(c.im_channels, c.im_channels,
                                       c.voxel_patch_size, c.activation, dtype=dt)
        self.proprio_preprocess = DenseBlock(c.low_dim_size, c.im_channels,
                                             c.activation, dtype=head)
        self.lang_preprocess = Dense(c.lang_emb_dim, seq_dim)
        self.pos_encoding = nn.Parameter(
            torch.empty(1, c.lang_max_seq_len + s ** 3, seq_dim))
        self.latents = nn.Parameter(torch.empty(c.num_latents, c.latent_dim))
        if c.use_flash_attention or c.stats_backend == "pallas":
            raise ValueError("the reference runs the plain attention and spatial softmax")
        drop = c.dropout_rate
        self.cross_attend = PreNormAttn(c.latent_dim, seq_dim, c.cross_heads,
                                        c.cross_dim_head, c.latent_dim, dt,
                                        cross=True, dropout_rate=drop)
        self.cross_ff = PreNormFF(c.latent_dim, dt)
        for i in range(c.depth):
            setattr(self, f"self_attn_{i}", PreNormAttn(
                c.latent_dim, c.latent_dim, c.latent_heads, c.latent_dim_head,
                c.latent_dim, dt, dropout_rate=drop))
            setattr(self, f"self_ff_{i}", PreNormFF(c.latent_dim, dt))
        self.decoder_cross_attn = PreNormAttn(
            seq_dim, c.latent_dim, c.cross_heads, c.cross_dim_head, seq_dim, dt,
            cross=True)
        self.up0 = Conv3DUpsampleBlock(seq_dim, c.final_dim, c.voxel_patch_size,
                                       c.voxel_patch_size, c.activation, dtype=dt,
                                       mode=c.upsample_mode,
                                       backend=c.upsample_conv_backend)
        self.final = Conv3DBlock(c.im_channels + c.final_dim, c.im_channels, 3, 1,
                                 c.activation, dtype=dt, padding=c.conv_padding,
                                 backend=c.conv_backend)
        self.trans_decoder = ContractFirstConv3D(c.im_channels, 1, 3, None, dtype=dt)
        # [keypoints (3C) + max (C)] of d0, dec and u
        feat_dim = 4 * c.im_channels + 4 * seq_dim + 4 * c.im_channels
        self.dense0 = DenseBlock(feat_dim, 256, c.activation, dtype=head)
        self.dense1 = DenseBlock(256, c.final_dim, c.activation, dtype=head)
        self.rot_grip_collision_ff = DenseBlock(
            c.final_dim, c.num_rotation_classes * 3 + c.num_grip_classes
            + c.num_collision_classes, None, dtype=head)
        if c.aux_trans_head:
            self.aux_trans_decoder = Dense(seq_dim, 1)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.pos_encoding.normal_(0.0, 1.0, generator=generator)
            self.latents.normal_(0.0, 1.0, generator=generator)

    @classmethod
    def initialized(cls, cfg: PerceiverConfig, generator=None) -> "PerceiverIO":
        """A new network with random weights drawn as flax draws them."""
        return init_weights(cls(cfg), generator)

    def _ssm(self, x):
        return spatial_softmax_3d(x)

    def forward(self, voxel_grid, proprio, lang_goal_embs, train: bool = False,
                deterministic: bool = True):
        """voxel_grid (B, V, V, V, initial_dim), proprio (B, low_dim_size),
        lang_goal_embs (B, 77, lang_emb_dim). train=True runs the UNet
        encoder's BatchNorm on batch statistics and updates its running
        statistics in place (the JAX `train=True` under
        `mutable=["batch_stats"]`); the default reads them.
        deterministic=False applies the attention dropout. Returns
        (q_trans (B,V,V,V), q_rot_grip (B,3R+2), q_collision (B,2)
        [, voxel_feat d0][, q_trans_aux (B, s^3)])."""
        c = self.cfg
        b = voxel_grid.shape[0]
        s = c.spatial_size
        if c.input_encoder == "unet":
            d0 = self.encoder_3d(voxel_grid, train)
        else:
            d0 = self.input_preprocess(voxel_grid)
        feats = [self._ssm(d0), torch.amax(d0, dim=(1, 2, 3))]

        ins = self.patchify(d0)
        if c.grip_proprio_scale != 1.0:
            proprio = torch.cat([proprio[:, :-1],
                                 proprio[:, -1:] * c.grip_proprio_scale], dim=-1)
        p = self.proprio_preprocess(proprio)
        p = p[:, None, None, None, :].expand(*ins.shape[:-1], c.im_channels)
        dt_ins = torch.promote_types(ins.dtype, p.dtype)
        ins = torch.cat([ins.to(dt_ins), p.to(dt_ins)], dim=-1)
        ins = ins.reshape(b, s ** 3, c.input_dim_before_seq)

        lang = self.lang_preprocess(lang_goal_embs)
        dt_seq = torch.promote_types(lang.dtype, ins.dtype)
        seq = torch.cat([lang.to(dt_seq), ins.to(dt_seq)], dim=1) + self.pos_encoding

        x = self.latents[None].expand(b, *self.latents.shape)
        x = self.cross_attend(x, seq, deterministic) + x
        x = self.cross_ff(x) + x
        for i in range(c.depth):
            x = getattr(self, f"self_attn_{i}")(x, None, deterministic) + x
            x = getattr(self, f"self_ff_{i}")(x) + x

        dec = self.decoder_cross_attn(seq, x, deterministic)
        dec = dec[:, c.lang_max_seq_len:].reshape(b, s, s, s, c.input_dim_before_seq)
        feats.extend([self._ssm(dec), torch.amax(dec, dim=(1, 2, 3))])

        u0 = self.up0(dec)
        dt_cat = torch.promote_types(d0.dtype, u0.dtype)
        u = self.final(torch.cat([d0.to(dt_cat), u0.to(dt_cat)], dim=-1))
        q_trans = widen(self.trans_decoder(u)[..., 0])
        feats.extend([self._ssm(u), torch.amax(u, dim=(1, 2, 3))])

        h = self.dense0(torch.cat([widen(f) for f in feats], dim=-1))
        h = self.dense1(h)
        rgc = self.rot_grip_collision_ff(h)
        q_rot_grip = rgc[:, : -c.num_collision_classes]
        q_collision = rgc[:, -c.num_collision_classes:]

        outputs = [q_trans, q_rot_grip, q_collision]
        if c.return_voxel_feat:
            outputs.append(d0)
        if c.aux_trans_head:
            outputs.append(self.aux_trans_decoder(widen(dec))[..., 0].reshape(b, -1))
        return tuple(outputs)
