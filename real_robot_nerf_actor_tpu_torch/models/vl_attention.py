"""Visual-language fusion (counterpart of the JAX package's
`models/vl_attention.py`; the reference's network_utils.py:1017-1131 and
attention.py): cross-attention from visual tokens to language tokens with
a tanh gate, its stacked transformer, and a per-location language gate
over a spatial map.

Numerics follow flax: LayerNorm epsilon 1e-6 (torch's default is 1e-5),
`nn.gelu` as the tanh approximation, attention scores in fp32 (the
products of the compute dtype accumulated in fp32, as
`preferred_element_type` asks), the softmax cast to v's dtype before the
second product. The attention is plain: the JAX module does not reach its
Pallas kernel either. Submodule names are the flax tree's (`LayerNorm_0`,
`norm_lang`, `to_q`, ..., `gate`; the transformer's unnamed `LayerNorm_i`,
`Dense_{2i}`, `Dense_{2i+1}`), so `convert.flax_to_state_dict` maps a flax
tree onto them. The gate initialises to zero, as in flax: a fresh block is
the identity.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense

_LN_EPS = 1e-6   # flax nn.LayerNorm's default


class VLCrossAttention(nn.Module):
    """Visual queries attend to language tokens; gated residual out.
    forward(visual (B, Nv, Dv), lang (B, Nl, Dl)) -> (B, Nv, Dv)."""

    def __init__(self, visual_dim: int, lang_dim: int, n_heads: int = 6,
                 d_head: int = 64, gated: bool = True,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.n_heads, self.d_head, self.gated = n_heads, d_head, gated
        inner = n_heads * d_head
        self.LayerNorm_0 = nn.LayerNorm(visual_dim, eps=_LN_EPS)
        self.norm_lang = nn.LayerNorm(lang_dim, eps=_LN_EPS)
        self.to_q = Dense(visual_dim, inner, use_bias=False, dtype=dtype)
        self.to_k = Dense(lang_dim, inner, use_bias=False, dtype=dtype)
        self.to_v = Dense(lang_dim, inner, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, visual_dim, dtype=dtype)
        if gated:
            self.gate = nn.Parameter(torch.zeros(1))

    def _heads(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.n_heads, self.d_head).transpose(1, 2)

    def forward(self, visual: torch.Tensor, lang: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.to_q(self.LayerNorm_0(visual)))
        ln = self.norm_lang(lang)
        k, v = self._heads(self.to_k(ln)), self._heads(self.to_v(ln))
        acc = torch.promote_types(q.dtype, torch.float32)
        sim = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * self.d_head ** -0.5
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(visual.shape[0], -1,
                                                 self.n_heads * self.d_head)
        out = self.to_out(out)
        if self.gated:
            out = out * torch.tanh(self.gate)
        return visual + out.to(visual.dtype)


class Visual3DLangTransformer(nn.Module):
    """`depth` blocks of VL cross-attention, then a GELU feed-forward (4x)
    with a residual, as the reference's 3-D VL transformer."""

    def __init__(self, visual_dim: int, lang_dim: int, depth: int = 1,
                 n_heads: int = 6, d_head: int = 64,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"vl_{i}", VLCrossAttention(visual_dim, lang_dim, n_heads,
                                                      d_head, dtype=dtype))
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(visual_dim, eps=_LN_EPS))
            setattr(self, f"Dense_{2 * i}", Dense(visual_dim, 4 * visual_dim, dtype=dtype))
            setattr(self, f"Dense_{2 * i + 1}", Dense(4 * visual_dim, visual_dim, dtype=dtype))

    def forward(self, visual: torch.Tensor, lang: torch.Tensor) -> torch.Tensor:
        x = visual
        for i in range(self.depth):
            x = getattr(self, f"vl_{i}")(x, lang)
            h = getattr(self, f"Dense_{2 * i}")(getattr(self, f"LayerNorm_{i}")(x))
            h = getattr(self, f"Dense_{2 * i + 1}")(F.gelu(h, approximate="tanh"))
            x = x + h.to(x.dtype)
        return x


class LanguageInformedVisualAttention(nn.Module):
    """Per-location language gate over a spatial map (FiLM-style attention,
    network_utils.py:1017-1063): feat * sigmoid(<feat, proj(lang)> / sqrt(C)).
    forward(feat (B, ..., C), lang_pooled (B, Dl))."""

    def __init__(self, features: int, lang_dim: int):
        super().__init__()
        self.lang_proj = Dense(lang_dim, features)

    def forward(self, feat: torch.Tensor, lang_pooled: torch.Tensor) -> torch.Tensor:
        c = feat.shape[-1]
        g = self.lang_proj(lang_pooled)
        g = g.reshape(g.shape[0], *([1] * (feat.dim() - 2)), c)
        attn = torch.sigmoid((feat * g).sum(dim=-1, keepdim=True) / math.sqrt(float(c)))
        return feat * attn
