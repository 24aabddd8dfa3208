"""The UNet convs' weight gradient (`ops/conv3d_wgrad_cuda.py`) on the CPU.

- `conv3d_wgrad_plain` against torch autograd's weight gradient of
  `F.conv3d` / `F.conv_transpose3d`, in float64, for each UNet conv class at
  small sizes: k3 s1 p1 (Cin 10), k3 s2 p1 on odd sizes (25 -> 13), the
  transposed k3 s2 under the DeconvBn3D crop, the k1 head with its bias;
  1e-12 of the largest |dW| (float64 sums of at most 10^4 products).
- The shallow and deep UNets' train-mode gradients through `Conv3dWgrad`
  against the modules' plain torch convs (`F.conv3d`, `F.conv_transpose3d`
  in place of the route) on the same weights and input, in float64: every
  parameter's and the input's gradient within 1e-12 of its largest |g|,
  with the weight gradient of each of the eleven convs taken by
  `conv3d_wgrad`; the same for the policy's other conv blocks (k5 with
  edge padding, the k5 s5 transposed conv, a biased k1, the subpixel conv).
- The act path's forward (no grad, or parameters that need none) and a
  bf16 call are the plain torch conv, bit for bit; a second derivative
  through the Function raises.
- `tiling`: the kernel's tiles and bricks for the two UNets' shapes fit a
  block.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.models import blocks as tb
from real_robot_nerf_actor_tpu_torch.ops import conv3d_wgrad_cuda as cw


def _randn(shape, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _close(got, want, rel):
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= rel * scale


# (kind, batch, spatial dims of the conv's input, cin, cout, k, stride, pad)
CASES = [
    ("conv", 1, (6, 7, 5), 10, 8, 3, 1, 1),
    ("conv", 2, (5, 4, 6), 8, 16, 3, 1, 1),
    ("conv", 1, (25, 25, 25), 4, 8, 3, 2, 1),
    ("conv", 1, (9, 6, 7), 16, 8, 3, 2, 1),
    ("transposed", 1, (5, 6, 4), 16, 8, 3, 2, 0),
    ("transposed", 2, (3, 3, 5), 10, 4, 3, 2, 0),
    ("head", 1, (6, 5, 7), 8, 16, 1, 1, 0),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[3]}to{c[4]}-s{c[6]}" for c in CASES])
def test_plain_matches_autograd(case):
    kind, n, dims, cin, cout, k, stride, pad = case
    x = _randn((n, cin, *dims), 0)
    if kind == "transposed":
        w = _randn((cin, cout, k, k, k), 1).requires_grad_()
        y = F.conv_transpose3d(x, w, stride=stride)
        out = [(d - 1) * stride for d in dims]     # DeconvBn3D's crop [1:1 + out]
        y = y[:, :, 1:1 + out[0], 1:1 + out[1], 1:1 + out[2]]
    else:
        w = _randn((cout, cin, k, k, k), 1).requires_grad_()
        bias = _randn((cout,), 2) if kind == "head" else None
        y = F.conv3d(x, w, bias, stride=stride, padding=pad)
    r = _randn(tuple(y.shape), 3)
    (y * r).sum().backward()
    xl = x.permute(0, 2, 3, 4, 1).contiguous()
    if kind == "transposed":
        g = torch.zeros((n, cout, *[(d - 1) * stride + k for d in dims]), dtype=x.dtype)
        g[:, :, 1:1 + out[0], 1:1 + out[1], 1:1 + out[2]] = r
        got = cw.conv3d_wgrad_plain(xl, g.permute(0, 2, 3, 4, 1).contiguous(), k, stride, 0)
    else:
        got = cw.conv3d_wgrad_plain(r.permute(0, 2, 3, 4, 1).contiguous(), xl, k, stride, pad)
    assert got.shape == w.shape and got.dtype == torch.float64
    _close(got, w.grad, 1e-12)


def _unet(deep, cin):
    cls = tb.MultiLayer3DEncoder if deep else tb.MultiLayer3DEncoderShallow
    m = tb.init_weights(cls(cin, 16), torch.Generator().manual_seed(0)).double()
    with torch.no_grad():      # nonzero head bias and BatchNorm affine
        for i, (name, p) in enumerate(m.named_parameters()):
            if not name.endswith("Conv_0.weight") and not name.endswith("ConvTranspose_0.weight"):
                p.add_(0.1 * _randn(tuple(p.shape), 100 + i))
    return m


@contextlib.contextmanager
def _plain_convs():
    """The blocks' convs as the plain torch calls, not the route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cw, "conv3d", F.conv3d)
        mp.setattr(cw, "conv_transpose3d", F.conv_transpose3d)
        yield


def _train_grads(m, x):
    x = x.clone().requires_grad_()
    out = m(x, train=True)
    out = out[0] if isinstance(out, tuple) else out
    (out * _randn(tuple(out.shape), 5)).sum().backward()
    return {"input": x.grad, **{n: p.grad for n, p in m.named_parameters()}}


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_unet_train_gradients_through_the_function(monkeypatch, deep):
    calls = []
    plain = cw.conv3d_wgrad_plain
    monkeypatch.setattr(cw, "conv3d_wgrad_plain",
                        lambda *a: calls.append(a[2:]) or plain(*a))
    m = _unet(deep, 10)
    ref = copy.deepcopy(m)
    x = _randn((1, 12, 12, 12, 10), 4)
    got = _train_grads(m, x)
    assert len(calls) == 11     # 7 ConvBnReLU3D, 3 DeconvBn3D, the 1x1 head
    assert sorted(set(calls)) == [(1, 1, 0), (3, 1, 1), (3, 2, 0), (3, 2, 1)]
    with _plain_convs():
        want = _train_grads(ref, x)
    assert len(calls) == 11
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-12)
    for a, b in zip(m.buffers(), ref.buffers()):   # the running statistics
        assert torch.equal(a, b)


@pytest.mark.parametrize("grad", ["no_grad", "frozen"])
def test_act_path_forward_is_the_plain_conv(grad):
    m = tb.init_weights(tb.MultiLayer3DEncoderShallow(10, 16), torch.Generator().manual_seed(1))
    x = _randn((1, 12, 12, 12, 10), 6, torch.float32)
    if grad == "frozen":
        for p in m.parameters():
            p.requires_grad_(False)
        x.requires_grad_()
        got = m(x)
        with _plain_convs():
            want = m(x)
        assert "ConvolutionBackward0" in _graph_names(got)
        assert "Conv3dWgradBackward" not in _graph_names(got)
    else:
        with torch.no_grad():
            got = m(x)
            with _plain_convs():
                want = m(x)
    assert torch.equal(got, want)


def test_grad_forward_is_the_plain_conv_bit_for_bit():
    """In grad mode the Function's forward is the plain call, and the graph
    holds one Conv3dWgrad node a UNet conv."""
    m = tb.init_weights(tb.MultiLayer3DEncoderShallow(10, 16), torch.Generator().manual_seed(2))
    ref = copy.deepcopy(m)
    x = _randn((1, 12, 12, 12, 10), 7, torch.float32)
    got = m(x, train=True)
    with _plain_convs():
        want = ref(x, train=True)
    assert torch.equal(got, want)
    assert _graph_names(got).count("Conv3dWgradBackward") == 11
    assert _graph_names(want).count("Conv3dWgradBackward") == 0


# the policy's other conv blocks at small sizes: (name, module, input dims, cin)
F64 = torch.float64
OTHER_BLOCKS = [
    ("k5_edge_padded", lambda: tb.Conv3DBlock(6, 8, 5, 1, "lrelu", F64), (7, 6, 5), 6),
    ("k3_zero_padded", lambda: tb.Conv3DBlock(6, 8, 3, 1, "lrelu", F64, padding="zeros"),
     (5, 6, 4), 6),
    ("k1_biased", lambda: tb.Conv3DBlock(6, 8, 1, 1, dtype=F64), (4, 5, 6), 6),
    ("transpose_k5_s5", lambda: tb.Conv3DUpsampleBlock(6, 8, 5, 5, "lrelu", F64,
                                                       mode="transpose"), (2, 3, 2), 6),
    ("subpixel_k3", lambda: tb.Conv3DUpsampleBlock(6, 4, 2, 3, "lrelu", F64, mode="subpixel"),
     (3, 2, 3), 6),
]


@pytest.mark.parametrize("block", OTHER_BLOCKS, ids=[b[0] for b in OTHER_BLOCKS])
def test_conv_blocks_take_the_route(monkeypatch, block):
    """Every Conv3d / ConvTranspose3d of the blocks, not the UNets' alone:
    float64 gradients through the Function (dW by the plain version here)
    against the plain torch convs, within 1e-12 of each one's largest |g|."""
    _, make, dims, cin = block
    calls = []
    plain = cw.conv3d_wgrad_plain
    monkeypatch.setattr(cw, "conv3d_wgrad_plain", lambda *a: calls.append(a[2:]) or plain(*a))
    m = tb.init_weights(make(), torch.Generator().manual_seed(3)).double()
    with torch.no_grad():    # nonzero biases
        for i, (name, p) in enumerate(m.named_parameters()):
            if name.endswith("bias"):
                p.add_(0.1 * _randn(tuple(p.shape), 200 + i))
    ref = copy.deepcopy(m)
    x = _randn((1, *dims, cin), 8)
    grads = []
    for net, ctx in ((m, contextlib.nullcontext()), (ref, _plain_convs())):
        xi = x.clone().requires_grad_()
        with ctx:
            out = net(xi)
            (out * _randn(tuple(out.shape), 9)).sum().backward()
        grads.append({"input": xi.grad, **{n: p.grad for n, p in net.named_parameters()}})
    convs = sum(isinstance(mod, (tb.Conv3d, tb.ConvTranspose3d)) for mod in m.modules())
    assert len(calls) == convs >= 1
    for name, want in grads[1].items():
        _close(grads[0][name], want, 1e-12)


def test_bf16_takes_the_plain_call_and_a_second_derivative_raises():
    conv = tb.init_weights(tb.Conv3DBlock(4, 8, 3, 1, dtype=torch.bfloat16),
                           torch.Generator().manual_seed(4))
    x = _randn((1, 5, 5, 5, 4), 10, torch.float32)
    assert "Conv3dWgradBackward" not in _graph_names(conv(x))
    conv32 = tb.init_weights(tb.Conv3DBlock(4, 8, 3, 1), torch.Generator().manual_seed(4))
    xi = x.clone().requires_grad_()
    y = conv32(xi)
    assert "Conv3dWgradBackward" in _graph_names(y)
    gw, gx = torch.autograd.grad(y.square().sum(), (conv32.Conv_0.weight, xi),
                                 create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        (gw.square().sum() + gx.square().sum()).backward()


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.append(type(fn).__name__)
        stack += [f for f, _ in fn.next_functions]
    return names


def _unet_shapes(deep):
    """(A, B, k, S dims, stride) of each conv's weight gradient in the cell's
    UNet (100^3 x 10) or the deep one at the same volume."""
    ch = (32, 64, 128, 256) if deep else (8, 16, 32, 64)
    sizes = (100, 50, 25, 13)
    out = [(ch[0], 10, 3, 100, 1)]
    for i in range(3):   # down: a stride-2 cell then a stride-1 one
        out += [(ch[i + 1], ch[i], 3, sizes[i + 1], 2), (ch[i + 1], ch[i + 1], 3, sizes[i + 1], 1)]
    for i in (3, 2, 1):   # up: S = the deconv's input, L = its whole output's gradient
        out.append((ch[i], ch[i - 1], 3, sizes[i], 2))
    out.append((64, ch[0], 1, 100, 1))
    return out


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("size", [4, 8])
def test_tiling_fits_a_block(deep, size):
    for a, b, k, d, stride in _unet_shapes(deep):
        ta, tbb, groups, brick = cw.tiling(a, b, k, (d, d, d), stride, size)
        slots = k ** 3 * (ta // cw.RA) * (tbb // cw.RB)
        assert ta % cw.RA == 0 and tbb % cw.RB == 0 and ta <= cw._up(a, cw.RA)
        assert tbb <= cw._up(b, cw.RB)
        assert 1 <= groups and slots * groups <= cw.THREADS < slots * (groups + 1)
        assert all(1 <= n <= d for n in brick)
        assert cw._stage_bytes(brick, ta, tbb, k, stride, size) <= cw.STAGE_BYTES
