"""CLIP's text tower and its tokenizer interface (the port's counterpart of
the JAX package's `models/clip_text.py`).

Token embedding + positional embedding -> `layers` causal pre-norm blocks
(multi-head attention, QuickGELU MLP) -> final LayerNorm. The tower returns
both the per-token embeddings (B, 77, width), which the policy's language
cross-attention consumes, and the EOT-pooled projection (B, embed_dim).

flax's numerics are kept: LayerNorm epsilon 1e-6, query scaled by
head_dim^-1/2 before the product, masked logits set to the dtype's lowest
value, pooling at argmax(tokens) (EOT has the largest id). The parameter
names follow the flax tree (`resblock_{i}.attn.query`, ...), so
`convert.clip_text_to_state_dict` maps a flax tree leaf by leaf, and
`convert_torch_clip_text_weights` maps an open CLIP checkpoint. Without a
checkpoint the weights are random, drawn from a `torch.Generator` as flax
would draw them (other numbers than JAX's key gives).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense

_LN_EPS = 1e-6   # flax nn.LayerNorm


def tokenize_simple(texts, context_length: int = 77, vocab_size: int = 49408) -> np.ndarray:
    """Deterministic stand-in tokenizer with CLIP's framing (SOT ... EOT,
    zero-padded, EOT the largest id): whitespace tokens hashed into the
    vocabulary's range."""
    if isinstance(texts, str):
        texts = [texts]
    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context_length), np.int64)
    for i, t in enumerate(texts):
        ids = [sot]
        for w in t.lower().strip().split():
            h = 0
            for ch in w:
                h = (h * 131 + ord(ch)) % (vocab_size - 3)
            ids.append(1 + h)
        ids = ids[: context_length - 1] + [eot]
        out[i, : len(ids)] = ids
    return out.astype(np.int32)


_BPE_CACHE: Dict[str, object] = {}


def tokenize(texts, context_length: int = 77, bpe_path: Optional[str] = None) -> np.ndarray:
    """(B, context_length) int32 token ids with CLIP's SOT/EOT framing: the
    real BPE with `bpe_path` (the standard merges file), else the hashing
    stand-in."""
    if bpe_path is not None:
        tok = _BPE_CACHE.get(bpe_path)
        if tok is None:
            from real_robot_nerf_actor_tpu_torch.models.clip_bpe import ClipBPETokenizer
            tok = _BPE_CACHE[bpe_path] = ClipBPETokenizer.from_file(bpe_path)
        return tok.tokenize(texts, context_length)
    return tokenize_simple(texts, context_length)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 1024   # RN50 projection dim


class _Attention(nn.Module):
    """flax MultiHeadDotProductAttention: query/key/value/out projections,
    their (width, heads, head_dim) kernels flattened to (width, width)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = (Dense(width, width) for _ in range(3))
        self.out = Dense(width, width)

    def forward(self, x, mask):
        b, n, w = x.shape
        hd = w // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        logits = q @ k.transpose(-1, -2)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(b, n, w))


class _ClipBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=_LN_EPS)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=_LN_EPS)
        self.fc = Dense(width, 4 * width)
        self.proj = Dense(4 * width, width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        h = self.fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h)   # QuickGELU
        return x + self.proj(h)


class ClipTextEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.width))
        for i in range(c.layers):
            setattr(self, f"resblock_{i}", _ClipBlock(c.width, c.heads))
        self.ln_final = nn.LayerNorm(c.width, eps=_LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(c.width, c.embed_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "ClipTextEncoder":
        """Random weights as flax initialises the tower: the token embedding
        N(0, 1/width), positions N(0, 0.01^2), the projection N(0, 0.02^2),
        every dense lecun-normal with zero bias, LayerNorms 1 and 0."""
        c = self.cfg
        self.token_embedding.weight.normal_(0.0, c.width ** -0.5, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        self.text_projection.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, tokens: torch.Tensor):
        """tokens (B, n) integer ids. Returns (pooled (B, embed_dim),
        per_token (B, n, width))."""
        b, n = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[None, :n]
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
        for i in range(self.cfg.layers):
            x = getattr(self, f"resblock_{i}")(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection, x


def convert_torch_clip_text_weights(state_dict: dict, cfg: ClipTextConfig
                                    ) -> Dict[str, torch.Tensor]:
    """An open CLIP checkpoint's text tower -> this module's state_dict."""
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
          for k, v in state_dict.items()}
    out = {"token_embedding.weight": sd["token_embedding.weight"],
           "positional_embedding": sd["positional_embedding"],
           "text_projection": sd["text_projection"],
           "ln_final.weight": sd["ln_final.weight"],
           "ln_final.bias": sd["ln_final.bias"]}
    w = cfg.width
    for i in range(cfg.layers):
        t, blk = f"transformer.resblocks.{i}.", f"resblock_{i}."
        wqkv, bqkv = sd[t + "attn.in_proj_weight"], sd[t + "attn.in_proj_bias"]
        for j, name in enumerate(("query", "key", "value")):
            out[blk + f"attn.{name}.weight"] = wqkv[j * w:(j + 1) * w]
            out[blk + f"attn.{name}.bias"] = bqkv[j * w:(j + 1) * w]
        pairs = (("attn.out", "attn.out_proj"), ("ln_1", "ln_1"), ("ln_2", "ln_2"),
                 ("fc", "mlp.c_fc"), ("proj", "mlp.c_proj"))
        for ours, theirs in pairs:
            out[blk + ours + ".weight"] = sd[t + theirs + ".weight"]
            out[blk + ours + ".bias"] = sd[t + theirs + ".bias"]
    return {k: v.contiguous() for k, v in out.items()}
