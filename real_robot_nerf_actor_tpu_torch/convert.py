"""flax variables -> the port's `state_dict`.

The port's modules carry the flax tree's names (see models/blocks.py), so a
leaf at `params/<a>/<b>/<leaf>` (or under `batch_stats`) becomes the
state_dict entry `<a>.<b>.<name>`, with its array rearranged to torch's
layout:

  Dense `kernel` (in, out)                -> `weight` (out, in)
  Conv `kernel` (k, k, k, in, out)        -> `weight` (out, in, k, k, k)
  2-D Conv `kernel` (k, k, in, out)       -> `weight` (out, in, k, k)
  2-D ConvTranspose `kernel` (k, k, in, out) (ConvEncoder's `deconv*`)
                                          -> `weight` (in, out, k, k), flipped
      in both spatial axes, as the 3-D one
  ConvTranspose `kernel` (k, k, k, in, out) -> `weight` (in, out, k, k, k),
      flipped in all three spatial axes: flax's ConvTranspose does not flip
      its kernel and torch's conv_transpose3d does
  LayerNorm / BatchNorm `scale`           -> `weight`
  BatchNorm `mean` / `var`                -> `running_mean` / `running_var`
  `bias`, `pos_encoding`, `latents`       -> as they are
  `pallas_kernel` / `pallas_bias`         -> as they are: the k3 kernel takes
      the flax (3, 3, 3, Cin, Cout) layout directly
  `lin_out_kernel` / `lin_out_bias`       -> as they are: the NeRF field's
      ResnetFC declares them as raw params, (d_hidden, d_out), in both
      packages

Inputs are numpy arrays (or anything `np.asarray` takes); no JAX needed.

`load_optax_state` carries a JAX optimizer state across as well, so that a
JAX run resumes in the port on the same trajectory: the Adam moments are
elementwise, so they take the same leaf mapping as the parameters. The
NeRF-Actor joint state (params `{"policy", "nerf"}`) maps by
`joint_to_state_dict`, and its optax state by `load_optax_state` as it is:
the moments' tree is the joint params tree. A field with `use_proposal`
carries `mlp_proposal` through both, and a quantized field's `QuantDense`
layers keep Dense's names (`kernel`, `bias`), so any field checkpoint
loads into either mode. The CLIP text tower maps by
`clip_text_to_state_dict`. The FeatureNeRF field (2-D encoder with
BatchNorm statistics, ResnetFC) maps by `pixelnerf_to_state_dict`; the
DINO ViT and the 2-D student map by `flax_to_state_dict` as they are.

The BC / RL slice keeps flax's scope names too, so each of its models maps
by `flax_to_state_dict` of the JAX package's variables ({"params": ...,
"batch_stats": ...} as numpy arrays), held by tests/test_torch_zoo.py and
test_torch_bc_rl.py: `TorchvisionResNet`, `PointNet2Encoder`,
`ClipVisualResNet` (the attention pool's `positional_embedding` as it is),
the module of every `make_embedding` entry, `ContinuousPolicy`, `NoiseMLP`
and `TwinCritic` (DiffusionBC / DiffusionQL: params, ema_params,
critic_params and critic_target each into its module), and SAC's nets
(the agent's params and target_params into `SACAgent.net` / `.target`;
log_alpha is a scalar). Torch-layout checkpoints (torchvision, MoCo v2,
pointnet2_cls, OpenAI CLIP, MAE) map by the converters beside each model.

Files written by flax's `serialization.to_bytes` (msgpack) read with
`read_flax_msgpack`, a reader in pure Python (the card's machine has
neither `msgpack` nor flax). The FeatureNeRF contrastive teacher's state
({"params", "extra": {"batch_stats"}, "opt"}) maps by
`teacher_to_state_dict`, its optax adam state by `load_optax_state`; the
pixelNeRF family's `ConvEncoder` and `ImplicitNet` map by
`flax_to_state_dict`.

The auxiliary models map by `flax_to_state_dict` as they are, their leaf
rules unchanged (tests/test_torch_aux_models.py): the CNN heads
(`conv{i}.Conv_0` HWIO -> OIHW, `film{i}.Dense_0`, `fc{i}`, `head`; the
conv maps are flattened in NHWC order in the port too, so `fc0`'s kernel
needs no row permutation), the VL modules (`LayerNorm_0`, `norm_lang`,
`to_q` / `to_k` / `to_v` / `to_out`, the `gate` as it is; the
transformer's unnamed `LayerNorm_{i}`, `Dense_{2i}`, `Dense_{2i+1}`) and
`MultiLayer3DEncoder` (flax numbers the stride-1 cell of each level before
its stride-2 cell, and the port's names follow).

Tensor parallelism (`parallel/`) cuts a state_dict by an explicit
placement (`parallel.mesh.shard_params_rule`): `shard_state_dict` gives
model rank r's shards, `gather_state_dict` puts the ranks' shards back
together. A column-parallel leaf is cut along its output features, in
`chunks` equal pieces each cut alike (to_kv holds k | v, GEGLU's Dense_0 h |
gates: rank r takes its heads of k and of v, never a contiguous half); a
row-parallel weight along its input features. Checkpoints are written
whole, so a tensor-parallel run's checkpoint loads at any world size.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path, value: np.ndarray):
    *mods, leaf = path
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 5 and mods and mods[-1].startswith("ConvTranspose"):
            value = value[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        elif value.ndim == 4 and mods and mods[-1].startswith(("ConvTranspose", "deconv")):
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {value.ndim}")
        leaf = "weight"
    else:
        leaf = _RENAME.get(leaf, leaf)
    return ".".join([*mods, leaf]), value


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} (nested dicts of arrays) -> a
    state_dict for the port's module of the same architecture."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            name, arr = _convert_leaf(path, np.asarray(value, np.float32))
            out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def joint_to_state_dict(params: Mapping[str, Any],
                        extra: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The NeRF-Actor joint state of the JAX package (params
    {"policy": ..., "nerf": ...}, extra {"batch_stats": the policy's}) ->
    the state_dict of the port's `nn.ModuleDict(policy=..., nerf=...)`:
    `policy.*` and `nerf.*`, the BatchNorm statistics under `policy.`."""
    stats = dict(extra or {}).get("batch_stats", {})
    return flax_to_state_dict({"params": params, "batch_stats": {"policy": stats}})


def pixelnerf_to_state_dict(params: Mapping[str, Any],
                            extra: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's FeatureNeRF state (params {"encoder", "mlp"},
    extra {"batch_stats": the encoder's BatchNorm statistics}) -> the
    state_dict of the port's `PixelNerfNet`: 2-D conv kernels HWIO -> OIHW,
    BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var."""
    stats = dict(extra or {}).get("batch_stats", {})
    return flax_to_state_dict({"params": params, "batch_stats": stats})


def clip_text_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's flax `ClipTextEncoder` variables ({"params": ...}
    or the params tree itself, arrays as numpy) -> the state_dict of the
    port's `models.clip_text.ClipTextEncoder`. Dense kernels are transposed;
    the attention's (width, heads, head_dim) query/key/value kernels and
    (heads, head_dim, width) out kernel are flattened to (width, width)
    first, their (heads, head_dim) biases to (width,); the embedding table
    becomes `token_embedding.weight`."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params):
        a = np.asarray(value, np.float32)
        *mods, leaf = path
        if leaf == "embedding":
            leaf = "weight"
        elif leaf == "kernel":
            if a.ndim == 3 and mods[-1] == "out":
                a = a.reshape(-1, a.shape[-1])
            elif a.ndim == 3:
                a = a.reshape(a.shape[0], -1)
            a, leaf = a.T, "weight"
        elif leaf == "bias" and a.ndim == 2:
            a = a.reshape(-1)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*mods, leaf])] = torch.tensor(np.ascontiguousarray(a))
    return out


def final_conv_as_plain(state_dict: Mapping[str, torch.Tensor],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """A PerceiverIO state_dict of `conv_backend: pallas` for the same net
    with the plain conv: `final.pallas_kernel` (3, 3, 3, Cin, Cout) becomes
    `final.Conv_0.weight` (Cout, Cin, 3, 3, 3), `final.pallas_bias`
    `final.Conv_0.bias`. prefix: the policy's, in a larger state_dict
    (`"policy."` in the NeRF-Actor joint one)."""
    sd = dict(state_dict)
    f = prefix + "final."
    sd[f + "Conv_0.weight"] = sd.pop(f + "pallas_kernel").permute(4, 3, 0, 1, 2)
    sd[f + "Conv_0.bias"] = sd.pop(f + "pallas_bias")
    return sd


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a leaf is cut over the model axis: "column" along its output
    features (torch dim 0 of a Dense weight, the bias), in `chunks` fused
    pieces cut alike; "row" along its input features (dim 1)."""
    kind: str
    chunks: int = 1

    @property
    def dim(self) -> int:
        return 0 if self.kind == "column" else 1


def shard_index(width: int, placement: Placement, rank: int, size: int) -> torch.Tensor:
    """The indices along `placement.dim` (whole width `width`) that model
    rank `rank` of `size` holds, in the order its shard holds them."""
    chunk = width // placement.chunks
    if width % placement.chunks or chunk % size:
        raise ValueError(f"a width of {width} in {placement.chunks} chunks does not "
                         f"split over {size} ranks")
    piece = chunk // size
    return torch.cat([torch.arange(k * chunk + rank * piece, k * chunk + (rank + 1) * piece)
                      for k in range(placement.chunks)])


def shard_tensor(x: torch.Tensor, placement: Placement, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s shard of the whole leaf `x`."""
    idx = shard_index(x.shape[placement.dim], placement, rank, size)
    return x.index_select(placement.dim, idx.to(x.device))


def shard_state_dict(state_dict: Mapping[str, torch.Tensor],
                     placements: Mapping[str, Placement], rank: int, size: int
                     ) -> Dict[str, torch.Tensor]:
    """Model rank `rank`'s tensor-parallel state_dict of a whole one: every
    leaf named in `placements` cut to its shard, the rest as they are."""
    return {k: shard_tensor(v, placements[k], rank, size) if k in placements else v
            for k, v in state_dict.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      placements: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """The whole state_dict of the model ranks' shards (shards[r] is rank
    r's): each leaf of `placements` put back at `shard_index`'s places, the
    rest taken from rank 0."""
    size = len(shards)
    out = {}
    for k, v in shards[0].items():
        pl = placements.get(k)
        if pl is None:
            out[k] = v
            continue
        shape = list(v.shape)
        shape[pl.dim] *= size
        whole = v.new_zeros(shape)
        for r, s in enumerate(shards):
            whole.index_copy_(pl.dim, shard_index(shape[pl.dim], pl, r, size).to(v.device),
                              s[k])
        out[k] = whole
    return out


def load_optax_state(optimizer, opt_state) -> None:
    """Fill the port's `train.trainer.Optimizer` from the state of the JAX
    package's `make_optimizer(optimizer.cfg)` (namedtuples and dicts as
    optax builds them, leaves as numpy arrays), nested as make_optimizer
    nests it for that config:
      ApplyIfFiniteState (skip_nonfinite > 0)
        -> MultiStepsState (accum_steps > 1)
          -> (clip's EmptyState, adam chain) when grad_clip > 0, else the
             adam chain: (ScaleByAdamState(count, mu, nu), ...).
    mu, nu and the MultiSteps accumulator are params trees; they go
    through `flax_to_state_dict`'s mapping to the parameters' names."""
    cfg = optimizer.cfg
    s = opt_state
    if cfg.skip_nonfinite > 0:
        optimizer.notfinite_count = int(s.notfinite_count)
        optimizer.total_notfinite = int(s.total_notfinite)
        optimizer.last_finite = bool(s.last_finite)
        s = s.inner_state
    if cfg.accum_steps > 1:
        optimizer.mini_step = int(s.mini_step)
        optimizer.gradient_step = int(s.gradient_step)
        acc = flax_to_state_dict({"params": s.acc_grads})
        optimizer.acc = [acc[n].to(p.device).clone()
                         for n, p in zip(optimizer.names, optimizer.params)]
        s = s.inner_opt_state
    if cfg.grad_clip > 0:
        s = s[1]
    adam = s[0]
    optimizer.load_moments(int(adam.count), flax_to_state_dict({"params": adam.mu}),
                           flax_to_state_dict({"params": adam.nu}))


def teacher_to_state_dict(params: Mapping[str, Any],
                          batch_stats: Optional[Mapping[str, Any]] = None
                          ) -> Dict[str, torch.Tensor]:
    """The JAX package's ContrastiveTeacher (params {"SpatialEncoder_0",
    "proj"}, batch_stats {"SpatialEncoder_0"}) -> the state_dict of the
    port's `train.teacher.ContrastiveTeacher`: 2-D conv kernels HWIO ->
    OIHW, the proj Dense transposed, BatchNorm scale / mean / var ->
    weight / running_mean / running_var."""
    return flax_to_state_dict({"params": params, "batch_stats": batch_stats or {}})


# msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md): the
# formats flax's serialization writes, and the rest of the spec's scalars
_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _MsgpackReader:
    """Decodes one msgpack object: strings as str, or as bytes with raw
    (flax reads its array headers so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._container("map", b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._container("array", b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._container("str", b & 0x1f)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self._unpack(fmt)
            return self._ext(n) if kind == "ext" else self._container(kind, n)
        raise ValueError(f"msgpack byte 0x{b:02x} is not a format")

    def _container(self, kind: str, n: int):
        if kind == "bin":
            return bytes(self._take(n))
        if kind == "str":
            s = bytes(self._take(n))
            return s if self.raw else s.decode("utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = bytes(self._take(n))
        if code in (1, 3):          # flax: ndarray, numpy scalar
            arr = _flax_ndarray(payload)
            return arr if code == 1 else arr[()]
        if code == 2:               # flax: native complex
            re_, im = _MsgpackReader(payload).read()
            return complex(re_, im)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _flax_ndarray(payload: bytes) -> np.ndarray:
    """flax's array encoding: msgpack [shape, dtype name, C-order bytes].
    bfloat16 (which numpy lacks) widens to float32, exactly."""
    shape, name, buf = _MsgpackReader(payload, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax splits arrays over 2^30 bytes into {"__msgpack_chunked_array__",
    "shape", "chunks"} maps; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str):
    """A file of flax's `serialization.to_bytes` / `msgpack_serialize` as
    `msgpack_restore` returns it: nested dicts (tuples and namedtuples as
    {"0": ..., "1": ...} or {field: ...}), numpy array leaves (read-only,
    on the file's bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)
