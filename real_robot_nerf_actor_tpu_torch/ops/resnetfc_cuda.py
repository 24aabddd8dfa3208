"""The serving renderer's fused W8A8 int8 ResnetFC (CUDA C++ kernels of
`csrc/resnetfc_int8.cu`) and their host helpers.

Counterpart of the JAX package's `ops/resnetfc_pallas.py`:
`fused_resnetfc_int8` replaces the Pallas kernel `_kernel` and
`fused_gather_resnetfc_int8` the Pallas kernel `_gather_kernel`. The host
helpers (`input_row_layout`, `pack_mlp_input`, `pack_resnetfc_params`,
`capture_act_amax`, `slice_gather_weights`) are torch code with the JAX
package's layouts, so their outputs compare one to one.

`pack_resnetfc_params` packs once per set of weights (the renderer calls
it when the weights are loaded): the JAX-layout tensors that the plain
versions read, and under "kernel" the layout the CUDA kernel reads, with
every transposition done there: first-layer and injection weights cut to
their live rows (the dropped rows are zero by construction) and stored
(out, in); the ten block matrices (out, in) in int8 (or bf16); the head's
first 8 columns. Static activation scales are a kernel argument
(`static_act_scales`), not a compile-time constant: recalibrating rebuilds
nothing.

The plain versions (`*_plain`) mirror the TPU kernels rounding point for
rounding point; the int8 products run exactly in float64 (each product an
integer of magnitude at most 127^2, a 512-term sum far below 2^53). On a
CUDA tensor the wrappers launch the kernel; on a CPU tensor they run the
plain version.

Two kernel designs share those rounding points (`mlp_design` picks one):
"wgmma", s8 wgmma on a ring of the int8 block weights (one bulk copy a
slice, from the copy `ring_layout` makes at pack time), for the int8 calls
at d_hidden 256 or 512 (the serving configs); "mma_sync", the first kernel,
for every other call. Both wrappers count the wgmma launches in
`wgmma_launches` beside `launches`.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.ops import _build

ActScales = Union[None, Sequence[float], torch.Tensor]


def input_row_layout(d_latent: int, num_freqs: int):
    """Lanes of the packed (N, 128) input row: latent [0, d_latent), then
    canon (3), dirs (3), num_freqs*3 wrapped phases. Returns (canon0, dirs0,
    theta0, width)."""
    canon0 = d_latent
    dirs0 = canon0 + 3
    theta0 = dirs0 + 3
    width = theta0 + num_freqs * 3
    if width > 128:
        raise ValueError("packed input row must fit 128 lanes")
    return canon0, dirs0, theta0, width


def pack_mlp_input(latent: torch.Tensor, canon: torch.Tensor, dirs: torch.Tensor,
                   num_freqs: int, freq_factor: float) -> torch.Tensor:
    """[latent | canon | dirs | phases wrapped to [-pi, pi) in fp32] ->
    (N, 128) bf16."""
    n = latent.shape[0]
    freqs = torch.from_numpy(
        freq_factor * (2.0 ** np.arange(num_freqs, dtype=np.float32))).to(canon.device)
    theta = canon.float()[:, None, :] * freqs[None, :, None]
    two_pi = torch.tensor(np.float32(2.0 * np.pi), device=canon.device)
    theta = (theta - two_pi * torch.round(theta / two_pi)).reshape(n, num_freqs * 3)
    row = torch.cat([latent.to(torch.bfloat16), canon.to(torch.bfloat16),
                     dirs.to(torch.bfloat16), theta.to(torch.bfloat16)], dim=-1)
    return F.pad(row, (0, 128 - row.shape[-1]))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_resnetfc_params(mlp_state: Mapping[str, torch.Tensor], d_latent: int = 64,
                         num_freqs: int = 6, d_hidden: int = 512, n_blocks: int = 5,
                         combine_layer: int = 3, head_dims: int = 4,
                         quantize: bool = True) -> dict:
    """Extract (and quantize) a ResnetFC's weights for the fused kernel.

    mlp_state: the port ResnetFC's state_dict (`Dense_0`, `lin_z_i`,
    `ResnetBlockFC_i.Dense_{0,1}`, `lin_out_kernel`, `lin_out_bias`).
    Returns the JAX package's packed dict (w_a/w_s/w_c (128, H) bf16 on the
    input-row lanes, wz (ncomb, 128, H) bf16, wq (2 nb, H, H) int8 or bf16
    in (in, out) layout, ws, bq, w_out (H, 128), b_out, b_in, bz) plus
    "kernel": the CUDA kernel's layout of the same numbers."""
    canon0, dirs0, theta0, _ = input_row_layout(d_latent, num_freqs)
    dev = mlp_state["Dense_0.weight"].device
    bf = torch.bfloat16
    w_in = mlp_state["Dense_0.weight"].T.to(bf)             # (d_in, H)
    d_code = 3 + num_freqs * 6

    def zeros128():
        return torch.zeros((128, d_hidden), dtype=bf, device=dev)

    w_a = zeros128()
    w_a[canon0:canon0 + 3] = w_in[0:3]
    w_a[dirs0:dirs0 + 3] = w_in[d_code:d_code + 3]
    w_s, w_c = zeros128(), zeros128()
    for f in range(num_freqs):
        dst = theta0 + f * 3
        w_s[dst:dst + 3] = w_in[3 + f * 6:6 + f * 6]
        w_c[dst:dst + 3] = w_in[6 + f * 6:9 + f * 6]
    b_in = mlp_state["Dense_0.bias"].float()
    wz, bz = [], []
    for i in range(min(combine_layer, n_blocks)):
        k = zeros128()
        k[:d_latent] = mlp_state[f"lin_z_{i}.weight"].T.to(bf)
        wz.append(k)
        bz.append(mlp_state[f"lin_z_{i}.bias"].float())
    wq, ws, bq = [], [], []
    for i in range(n_blocks):
        for d in ("Dense_0", "Dense_1"):
            k = mlp_state[f"ResnetBlockFC_{i}.{d}.weight"].T.float()   # (in, out)
            if quantize:
                amax = k.abs().amax(dim=0, keepdim=True)
                scale = amax / torch.tensor(127.0, device=dev) + 1e-12
                wq.append(torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8))
                ws.append(scale[0])
            else:
                wq.append(k.to(bf))
                ws.append(torch.ones(k.shape[1], device=dev))
            bq.append(mlp_state[f"ResnetBlockFC_{i}.{d}.bias"].float())
    w_out = torch.zeros((d_hidden, 128), dtype=bf, device=dev)
    w_out[:, :head_dims] = mlp_state["lin_out_kernel"][:, :head_dims].to(bf)
    b_out = torch.zeros(128, device=dev)
    b_out[:head_dims] = mlp_state["lin_out_bias"][:head_dims].float()
    empty_z = torch.zeros((0, 128, d_hidden), dtype=bf, device=dev)
    packed = {
        "w_a": w_a, "w_s": w_s, "w_c": w_c, "b_in": b_in,
        "wz": torch.stack(wz) if wz else empty_z,
        "bz": torch.stack(bz) if bz else torch.zeros((0, d_hidden), device=dev),
        "wq": torch.stack(wq), "ws": torch.stack(ws), "bq": torch.stack(bq),
        "w_out": w_out, "b_out": b_out,
    }
    packed["kernel"] = _kernel_layout(packed, d_latent, num_freqs, head_dims)
    return packed


def _kernel_layout(packed: dict, d_latent: int, num_freqs: int, head_dims: int) -> dict:
    if head_dims > 8:
        raise ValueError(f"the kernel computes 8 head columns, not {head_dims}")
    canon0, _, _, width = input_row_layout(d_latent, num_freqs)
    n_aux = width - canon0
    k_in = _round_up(3 * n_aux, 16)
    k_lat = max(16, _round_up(d_latent, 16))
    w_in = torch.cat([packed["w_a"][canon0:width], packed["w_s"][canon0:width],
                      packed["w_c"][canon0:width]])
    w_in = F.pad(w_in, (0, 0, 0, k_in - 3 * n_aux)).T.contiguous()
    wz = packed["wz"][:, :k_lat].transpose(1, 2).contiguous()
    if wz.numel() == 0:
        wz = torch.zeros(16, dtype=torch.bfloat16, device=w_in.device)
    bz = packed["bz"].contiguous() if packed["bz"].numel() else torch.zeros(
        1, device=w_in.device)
    wq = packed["wq"].transpose(1, 2).contiguous()
    kernel = {
        "w_in": w_in, "b_in": packed["b_in"].contiguous(), "wz": wz, "bz": bz,
        "wq": wq, "ws": packed["ws"].contiguous(), "bq": packed["bq"].contiguous(),
        "w_out": packed["w_out"][:, :8].T.contiguous(),
        "b_out": packed["b_out"][:8].contiguous(),
        "d_latent": d_latent, "n_aux": n_aux, "k_in": k_in, "k_lat": k_lat,
    }
    if wq.dtype == torch.int8 and wq.shape[2] % 32 == 0:
        kernel["wq_ring"] = ring_layout(wq)
    return kernel


def ring_layout(wq: torch.Tensor) -> torch.Tensor:
    """The int8 block matrices wq (M, N, K), (out, in), as the wgmma kernel's
    weight ring copies them: each matrix's K / 32 slices in order, each the
    contiguous (N x 32)-byte shared-memory image of the slice with the
    32-byte swizzle (rows of 32 bytes, the two 16-byte halves swapped on
    rows whose bit 2 is set), so that one bulk copy moves a slice. Byte
    (n, 32 s + c) of matrix m lands at ((m K / 32 + s) N + n) 32 +
    (c ^ 16 ((n >> 2) & 1))."""
    m, n, k = wq.shape
    x = wq.reshape(m, n, k // 32, 2, 16).permute(0, 2, 1, 3, 4)
    swap = ((torch.arange(n, device=wq.device) >> 2) & 1).bool()[None, None, :, None, None]
    return torch.where(swap, x.flip(3), x).contiguous().reshape(m, n, k)


def slice_gather_weights(packed: dict, d_latent: int = 64, num_freqs: int = 6) -> dict:
    """Views of pack_resnetfc_params output for the gather-fused kernel:
    aux rows of the first-layer/selector matrices and latent rows of the
    injection matrices. Exact: the dropped rows are zero."""
    canon0, _, _, width = input_row_layout(d_latent, num_freqs)
    return {
        "a_aux": packed["w_a"][canon0:width], "s_aux": packed["w_s"][canon0:width],
        "c_aux": packed["w_c"][canon0:width], "b_in": packed["b_in"],
        "wz_lat": packed["wz"][:, :d_latent], "bz": packed["bz"],
        "wq": packed["wq"], "ws": packed["ws"], "bq": packed["bq"],
        "w_out": packed["w_out"], "b_out": packed["b_out"],
    }


def static_act_scales(scales: Sequence[float], device) -> torch.Tensor:
    """(2, L) fp32 [xs; inv] from host floats, inv = 1/xs in double rounded
    once to fp32, as the TPU kernel's compile-time constants round."""
    xs = np.asarray([float(s) for s in scales], np.float64)
    return torch.from_numpy(np.stack([xs, 1.0 / xs]).astype(np.float32)).to(device)


def _dot(a, w):
    """bf16 (or fp32) operands, exact products, fp32 accumulation."""
    return a.float() @ w.float()


def _dense(t, packed, idx, quantized, act_scales):
    if not quantized:
        return _dot(t, packed["wq"][idx]) + packed["bq"][idx][None]
    t32 = t.float()
    if act_scales is None:
        xs = t32.abs().amax(dim=1, keepdim=True) / torch.tensor(
            127.0, device=t.device) + 1e-8
        inv = 1.0 / xs
    else:
        xs, inv = act_scales[0, idx], act_scales[1, idx]
    tq = torch.clamp(torch.round(t32 * inv), -127, 127)
    acc = (tq.double() @ packed["wq"][idx].double()).float()
    return acc * xs * packed["ws"][idx][None] + packed["bq"][idx][None]


def _as_scales(act_scales: ActScales, n_blocks: int, device):
    if act_scales is None:
        return None
    if not isinstance(act_scales, torch.Tensor):
        act_scales = static_act_scales(act_scales, device)
    if tuple(act_scales.shape) != (2, 2 * n_blocks):
        raise ValueError(f"act_scales of shape {tuple(act_scales.shape)}, want "
                         f"(2, {2 * n_blocks})")
    return act_scales.to(device=device, dtype=torch.float32).contiguous()


def _residual_chain(h, lat, wz, packed, n_blocks, combine_layer, quantized,
                    act_scales):
    for blk in range(n_blocks):
        if blk < combine_layer:
            h = h + (_dot(lat, wz[blk]) + packed["bz"][blk][None])
        t = torch.clamp_min(h.to(torch.bfloat16), 0)
        a0 = _dense(t, packed, 2 * blk, quantized, act_scales)
        u = torch.clamp_min(a0.to(torch.bfloat16), 0)
        h = h + _dense(u, packed, 2 * blk + 1, quantized, act_scales)
    hidden = torch.clamp_min(h, 0).to(torch.bfloat16)
    out = (_dot(hidden, packed["w_out"]) + packed["b_out"][None]).to(torch.bfloat16)
    return out, hidden


def capture_act_amax(zi: torch.Tensor, packed_bf16: dict, n_blocks: int = 5,
                     combine_layer: int = 3) -> torch.Tensor:
    """The bf16 kernel's forward recording the abs-max of each block
    matmul's input (the relu'd t and u of every block): the calibration pass
    behind static activation scales. packed_bf16 =
    pack_resnetfc_params(..., quantize=False). Returns (2 n_blocks,) fp32."""
    p = packed_bf16
    zi = zi.to(torch.bfloat16)
    zi32 = zi.float()
    h = (_dot(zi, p["w_a"]) + _dot(torch.sin(zi32).to(torch.bfloat16), p["w_s"])
         + _dot(torch.cos(zi32).to(torch.bfloat16), p["w_c"]) + p["b_in"][None])
    amaxes = []
    for blk in range(n_blocks):
        if blk < combine_layer:
            h = h + (_dot(zi, p["wz"][blk]) + p["bz"][blk][None])
        t = torch.clamp_min(h.to(torch.bfloat16), 0)
        amaxes.append(t.float().abs().amax())
        u = torch.clamp_min((_dot(t, p["wq"][2 * blk]) + p["bq"][2 * blk][None])
                            .to(torch.bfloat16), 0)
        amaxes.append(u.float().abs().amax())
        h = h + (_dot(u, p["wq"][2 * blk + 1]) + p["bq"][2 * blk + 1][None])
    return torch.stack(amaxes)


def fused_resnetfc_int8_plain(zi: torch.Tensor, packed: dict, n_blocks: int = 5,
                              combine_layer: int = 3, quantized: bool = True,
                              act_scales: ActScales = None):
    """The TPU `_kernel` in plain torch: (out (N, 128) bf16, hidden (N, H)
    bf16)."""
    scales = _as_scales(act_scales, n_blocks, zi.device) if quantized else None
    zi = zi.to(torch.bfloat16)
    zi32 = zi.float()
    h = (_dot(zi, packed["w_a"])
         + _dot(torch.sin(zi32).to(torch.bfloat16), packed["w_s"])
         + _dot(torch.cos(zi32).to(torch.bfloat16), packed["w_c"])
         + packed["b_in"][None])
    return _residual_chain(h, zi, packed["wz"], packed, n_blocks, combine_layer,
                           quantized, scales)


def fused_gather_resnetfc_int8_plain(vox_rows: torch.Tensor, flat: torch.Tensor,
                                     w8: torch.Tensor, aux: torch.Tensor, packed: dict,
                                     d_latent: int = 64, num_freqs: int = 6,
                                     n_blocks: int = 5, combine_layer: int = 3,
                                     quantized: bool = True,
                                     act_scales: ActScales = None):
    """The TPU `_gather_kernel` in plain torch: gather rows, lerp in fp32
    (rounded to bf16 after), then the chain on the aux and latent rows."""
    scales = _as_scales(act_scales, n_blocks, vox_rows.device) if quantized else None
    sl = slice_gather_weights(packed, d_latent, num_freqs)
    rows = vox_rows[flat.long()]
    wt = w8.float().T
    lat = rows[:, :d_latent].float() * wt[:, 0:1]
    for c in range(1, 8):
        lat = lat + rows[:, c * d_latent:(c + 1) * d_latent].float() * wt[:, c:c + 1]
    lat = lat.to(torch.bfloat16)
    aux_t = aux.T.to(torch.bfloat16)
    aux32 = aux_t.float()
    h = (_dot(aux_t, sl["a_aux"])
         + _dot(torch.sin(aux32).to(torch.bfloat16), sl["s_aux"])
         + _dot(torch.cos(aux32).to(torch.bfloat16), sl["c_aux"])
         + sl["b_in"][None])
    return _residual_chain(h, lat, sl["wz_lat"], packed, n_blocks, combine_layer,
                           quantized, scales)


DESIGNS = ("wgmma", "mma_sync")


def mlp_design(quantized: bool, d_hidden: int, k_in: int, k_lat: int) -> str:
    """The kernel design that runs a call: "wgmma" for int8 block products
    at d_hidden 256 or 512 with k_in <= 112 and k_lat <= 64 (what shared
    memory holds beside the fp32 residual), "mma_sync" (the first kernel)
    for every other call."""
    if quantized and d_hidden in (256, 512) and k_in <= 112 and k_lat <= 64:
        return "wgmma"
    return "mma_sync"


def _pick_design(design, quantized: bool, kp: dict) -> str:
    """`design` None takes mlp_design's; a named one must be able to run the
    call (the first kernel runs every call)."""
    d_hidden = kp["b_in"].shape[0]
    routed = mlp_design(quantized, d_hidden, kp["k_in"], kp["k_lat"])
    if design is None:
        return routed
    if design not in DESIGNS:
        raise ValueError(f"design {design!r}: one of {DESIGNS}")
    if design == "wgmma" and routed != "wgmma":
        raise ValueError(f"the wgmma design does not take quantized={quantized}, "
                         f"d_hidden {d_hidden}, k_in {kp['k_in']}, k_lat {kp['k_lat']}")
    return design


def _check_weights(kp: dict, dev, quantized: bool, d_hidden: int, n_blocks: int):
    wdt = torch.int8 if quantized else torch.bfloat16
    if kp["wq"].dtype != wdt:
        raise TypeError(f"block weights are {kp['wq'].dtype}: pack with "
                        f"quantize={quantized}")
    if tuple(kp["wq"].shape) != (2 * n_blocks, d_hidden, d_hidden):
        raise ValueError(f"block weights of shape {tuple(kp['wq'].shape)}")
    for k, v in kp.items():
        if isinstance(v, torch.Tensor) and (v.device != dev or not v.is_contiguous()):
            raise ValueError(f"packed weight {k} must be contiguous on {dev}")


def _weight_ptrs(kp, scales, design):
    """The kernel's weight pointers; the wgmma design reads the block
    matrices in ring_layout."""
    wq = "wq_ring" if design == "wgmma" else "wq"
    return [kp[k].data_ptr() for k in ("w_in", "b_in", "wz", "bz", wq, "ws", "bq",
                                       "w_out", "b_out")] \
        + [None if scales is None else scales.data_ptr()]


def fused_resnetfc_int8(zi: torch.Tensor, packed: dict, n_blocks: int = 5,
                        combine_layer: int = 3, quantized: bool = True,
                        act_scales: ActScales = None, design: str = None):
    """zi: (N, 128) bf16 from pack_mlp_input (or the renderer's assembly).
    Returns (out (N, 128) bf16, head dims in the leading columns; hidden
    (N, H) bf16, the relu'd last hidden). act_scales: None (dynamic per-row
    scales), 2*n_blocks host floats, or a (2, 2*n_blocks) tensor from
    static_act_scales. design: None (mlp_design's choice), or "mma_sync" /
    "wgmma" to run one kernel design (for comparing the two)."""
    if zi.device.type == "cpu":
        _pick_design(design, quantized, packed["kernel"])
        return fused_resnetfc_int8_plain(zi, packed, n_blocks, combine_layer,
                                         quantized, act_scales)
    if not zi.is_cuda:
        raise ValueError(f"fused_resnetfc_int8: need a CUDA tensor, got {zi.device}")
    if zi.dtype != torch.bfloat16 or zi.dim() != 2 or zi.shape[1] != 128 \
            or not zi.is_contiguous():
        raise ValueError("fused_resnetfc_int8: zi must be a contiguous (N, 128) "
                         f"bf16 tensor, got {tuple(zi.shape)} {zi.dtype}")
    kp = packed["kernel"]
    design = _pick_design(design, quantized, kp)
    d_hidden = kp["b_in"].shape[0]
    _check_weights(kp, zi.device, quantized, d_hidden, n_blocks)
    scales = _as_scales(act_scales, n_blocks, zi.device) if quantized else None
    n = zi.shape[0]
    out = torch.empty((n, 128), dtype=torch.bfloat16, device=zi.device)
    hidden = torch.empty((n, d_hidden), dtype=torch.bfloat16, device=zi.device)
    lib = _build.load("resnetfc_int8")
    with torch.cuda.device(zi.device):
        code = lib.resnetfc_int8_fwd(
            zi.data_ptr(), *_weight_ptrs(kp, scales, design), out.data_ptr(), hidden.data_ptr(),
            n, kp["d_latent"], kp["n_aux"], d_hidden, n_blocks, combine_layer, kp["k_in"],
            kp["k_lat"], int(quantized), int(design == "wgmma"),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"fused_resnetfc_int8 ({design})")
    fused_resnetfc_int8.launches += 1
    fused_resnetfc_int8.wgmma_launches += design == "wgmma"
    return out, hidden


fused_resnetfc_int8.launches = 0
fused_resnetfc_int8.wgmma_launches = 0


def fused_gather_resnetfc_int8(vox_rows: torch.Tensor, flat: torch.Tensor,
                               w8: torch.Tensor, aux: torch.Tensor, packed: dict,
                               d_latent: int = 64, num_freqs: int = 6,
                               n_blocks: int = 5, combine_layer: int = 3,
                               quantized: bool = True, act_scales: ActScales = None,
                               design: str = None):
    """Gather-fused serving forward. vox_rows: (cells, 8*d_latent) bf16/fp32,
    the corner-expanded grid as rows; flat: (N,) int32 in-bounds row
    indices; w8: (8, N) fp32 lerp weights; aux: (6 + 3F, N) bf16 [canon |
    dirs | wrapped phases] (all from ray_expand). Returns (out (N, 128)
    bf16, hidden (N, H) bf16), rows in the input order. design: as for
    fused_resnetfc_int8."""
    if vox_rows.device.type == "cpu":
        _pick_design(design, quantized, packed["kernel"])
        return fused_gather_resnetfc_int8_plain(vox_rows, flat, w8, aux, packed,
                                                d_latent, num_freqs, n_blocks,
                                                combine_layer, quantized, act_scales)
    dev = vox_rows.device
    if not all(t.is_cuda and t.device == dev for t in (vox_rows, flat, w8, aux)):
        raise ValueError("fused_gather_resnetfc_int8: all inputs must lie on one "
                         "CUDA device")
    n = flat.shape[0]
    kp = packed["kernel"]
    if kp["d_latent"] != d_latent:
        raise ValueError(f"weights packed for d_latent {kp['d_latent']}, not {d_latent}")
    if (vox_rows.dtype not in (torch.bfloat16, torch.float32) or flat.dtype != torch.int32
            or w8.dtype != torch.float32 or aux.dtype != torch.bfloat16
            or vox_rows.dim() != 2 or vox_rows.shape[1] != 8 * d_latent
            or tuple(w8.shape) != (8, n) or tuple(aux.shape) != (kp["n_aux"], n)
            or not all(t.is_contiguous() for t in (vox_rows, flat, w8, aux))):
        raise ValueError("fused_gather_resnetfc_int8: bad inputs "
                         f"{tuple(vox_rows.shape)} {vox_rows.dtype}, {tuple(flat.shape)} "
                         f"{flat.dtype}, {tuple(w8.shape)}, {tuple(aux.shape)}")
    design = _pick_design(design, quantized, kp)
    d_hidden = kp["b_in"].shape[0]
    _check_weights(kp, dev, quantized, d_hidden, n_blocks)
    scales = _as_scales(act_scales, n_blocks, dev) if quantized else None
    out = torch.empty((n, 128), dtype=torch.bfloat16, device=dev)
    hidden = torch.empty((n, d_hidden), dtype=torch.bfloat16, device=dev)
    lib = _build.load("resnetfc_int8")
    with torch.cuda.device(dev):
        code = lib.gather_resnetfc_int8_fwd(
            vox_rows.data_ptr(), flat.data_ptr(), w8.data_ptr(), aux.data_ptr(),
            *_weight_ptrs(kp, scales, design), out.data_ptr(), hidden.data_ptr(), n, d_latent,
            kp["n_aux"], d_hidden, n_blocks, combine_layer, kp["k_in"], kp["k_lat"],
            int(quantized), int(vox_rows.dtype == torch.float32), int(design == "wgmma"),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"fused_gather_resnetfc_int8 ({design})")
    fused_gather_resnetfc_int8.launches += 1
    fused_gather_resnetfc_int8.wgmma_launches += design == "wgmma"
    return out, hidden


fused_gather_resnetfc_int8.launches = 0
fused_gather_resnetfc_int8.wgmma_launches = 0


def mlp_ops_per_row(d_hidden: int, n_blocks: int, combine_layer: int, k_in: int,
                    k_lat: int, quantized: bool):
    """(block-matmul ops, bf16 flops) per row as the kernel computes them:
    2*H*H for each of the 2 n_blocks block products (int8 when quantized),
    2*H*K for the first layer and each injection, 2*H*8 for the head."""
    blocks = 2 * n_blocks * 2 * d_hidden * d_hidden
    bf16 = 2 * d_hidden * (k_in + min(combine_layer, n_blocks) * k_lat + 8)
    return (blocks, bf16) if quantized else (0, blocks + bf16)

