"""The bf16 convs' weight-gradient kernel (``ops/wgrad_kernel.py``, ``csrc/conv_wgrad.cu``).

On the CPU: the wrapper's plain path is ``layers._conv_weight_partials`` bit
for bit, it raises on what the kernel does not take, it launches nothing, its
launch plan fits every conv of both model families, and the kernel's
addressing (position table, A rows, B core matrices), emulated in torch,
gives the plain partials exactly on integer-valued operands.

On the card (``-m chip``; each test skips without CUDA): at res8's, res15's
five dilations', res26-narrow's, cnn-trad-pool2's and cnn-one-fstride4's
geometries, each sample's kernel partial is the same bits in calls of 4, 8,
16, 64 and 256 rows, lies within ``n_terms * 2**-24 * sum|products|`` of its
float64 truth, and a dead input channel's gradient is exactly 0.

    python -m pytest tests/test_torch_wgrad_kernel.py -m chip   # on a machine with an NVIDIA H100
"""

import pytest
import torch

from honk_tpu_torch.models import find_config, find_model, layers
from honk_tpu_torch.models.registry import ConfigType
from honk_tpu_torch.ops import wgrad_kernel
from honk_tpu_torch.ops.wgrad_kernel import KC, conv_wgrad, plan

# (in channels, out channels, kernel, stride, padding, dilation, input H x W): the list of
# tests/test_torch_bf16_ranks.py::COLUMN_GEOMETRIES (that file imports JAX, this one does not).
COLUMN_GEOMETRIES = [(4, 6, (3, 3), (1, 1), (1, 1), (1, 1), (9, 7)), (4, 6, (3, 3), (1, 1), (2, 2), (2, 2), (9, 7)),
                     (1, 8, (20, 8), (1, 1), (0, 0), (1, 1), (101, 40)), (3, 5, (4, 3), (1, 4), (0, 0), (1, 1), (21, 40)),
                     (2, 3, (3, 3), (2, 3), (1, 2), (1, 1), (11, 13))]

# The models' own convs: res8's conv0 and residual conv (after its 4x3 pool), res15's five dilations,
# res26-narrow's residual conv (after its 2x2 pool), cnn-trad-pool2's conv1 and conv2 (after its 2x2
# pool), cnn-one-fstride4's conv1.
CARD_GEOMETRIES = {
    "res8-conv0": (1, 45, (3, 3), (1, 1), (1, 1), (1, 1), (101, 40)),
    "res8-conv1": (45, 45, (3, 3), (1, 1), (1, 1), (1, 1), (25, 13)),
    **{f"res15-d{d}": (45, 45, (3, 3), (1, 1), (d, d), (d, d), (101, 40)) for d in (1, 2, 4, 8, 16)},
    "res26-narrow-conv1": (19, 19, (3, 3), (1, 1), (1, 1), (1, 1), (50, 20)),
    "cnn-trad-pool2-conv1": (1, 64, (20, 8), (1, 1), (0, 0), (1, 1), (101, 40)),
    "cnn-trad-pool2-conv2": (64, 64, (10, 4), (1, 1), (0, 0), (1, 1), (41, 16)),
    "cnn-one-fstride4-conv1": (1, 186, (101, 8), (1, 4), (0, 0), (1, 1), (101, 40)),
}


def operands(geometry, rows, seed=0, device="cpu", integers=False):
    """Seeded bf16 (x, gy, weight shape, (stride, padding, dilation)) of ``rows`` samples."""
    c, o, k, s, p, d, hw = geometry
    g = torch.Generator().manual_seed(seed)
    out_hw = wgrad_kernel.out_size(hw, k, s, p, d)
    if integers:  # every product and sum exact in float32 and float64
        x = torch.randint(-4, 5, (rows, c, *hw), generator=g).bfloat16()
        gy = torch.randint(-4, 5, (rows, o, *out_hw), generator=g).bfloat16()
    else:
        x = torch.randn((rows, c, *hw), generator=g).bfloat16()
        gy = torch.randn((rows, o, *out_hw), generator=g).bfloat16()
    return x.to(device), gy.to(device), torch.Size((o, c, *k)), (s, p, d)


def geometry_id(g):
    return "c{}o{}k{}s{}p{}d{}".format(*g[:6])


# --- the CPU path ------------------------------------------------------------


@pytest.mark.parametrize("geometry", COLUMN_GEOMETRIES, ids=geometry_id)
def test_the_cpu_path_is_the_plain_partials_bit_for_bit(geometry):
    x, gy, shape, geo = operands(geometry, 3)
    got = conv_wgrad(gy, x, shape, geo)
    want = layers._conv_weight_partials(gy.float(), x, shape, geo)
    assert got.dtype == torch.float32 and got.shape == (3, shape[0], shape[1] * shape[2] * shape[3])
    assert torch.equal(got, want)
    summed = layers._conv_weight_grad(gy, x, shape, geo)
    assert summed.dtype == torch.float64 and torch.equal(summed, want.sum(dim=0, dtype=torch.float64).view(shape))


def _refusals():
    x, gy, shape, geo = operands(COLUMN_GEOMETRIES[0], 2)
    return {
        "x float32": (gy, x.float(), shape, geo),
        "gy float32": (gy.float(), x, shape, geo),
        "x float16": (gy, x.half(), shape, geo),
        "x not contiguous": (gy, x.transpose(2, 3).contiguous().transpose(2, 3), shape, geo),
        "gy not contiguous": (gy.transpose(2, 3).contiguous().transpose(2, 3), x, shape, geo),
        "gy's size": (gy[:, :, :-1].contiguous(), x, shape, geo),
        "gy's rows": (gy[:1].contiguous(), x, shape, geo),
        "gy's channels": (gy[:, :-1].contiguous(), x, shape, geo),
        "x's channels": (gy, x[:, :-1].contiguous(), shape, geo),
        "3-D x": (gy, x[0], shape, geo),
        "another geometry": (gy, x, shape, ((1, 1), (0, 0), (1, 1))),
        "a device not cuda": (gy.to("meta"), x.to("meta"), shape, geo),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        conv_wgrad(*_refusals()[case])


def test_the_launch_counter_stays_0_on_the_cpu():
    before = wgrad_kernel.launches
    x, gy, shape, geo = operands(COLUMN_GEOMETRIES[1], 2)
    conv_wgrad(gy, x, shape, geo)
    model = find_model("res8-narrow")(find_config("res8-narrow"), dtype=torch.bfloat16).train()
    with layers.wide_grads() as wide:
        model(torch.randn(2, 101, 40)).sum().backward()
    assert any(p in wide for p in layers.cast_parameters(model))
    assert wgrad_kernel.launches == before == 0


@pytest.mark.parametrize("layout", ["sum", "channels_last"])
def test_a_bf16_conv_takes_a_strided_cotangent_and_input(layout):
    """Autograd hands a bf16 conv a stride-0 cotangent for ``.sum()`` of its output, and a channels_last
    one and input where the model runs channels_last: the weight gradient takes them, the same bits
    as from contiguous operands of the same values."""
    g = torch.Generator().manual_seed(0)
    layer = torch.nn.Conv2d(4, 6, 3, padding=1, bias=False)
    x = torch.randn((3, 4, 9, 7), generator=g)
    gy = torch.ones(3, 6, 9, 7) if layout == "sum" else torch.randn((3, 6, 9, 7), generator=g)

    def grad(x, backward):
        with layers.wide_grads() as wide:
            backward(layers.conv(layer, x, torch.bfloat16))
        return wide[layer.weight]

    if layout == "sum":
        got = grad(x, lambda y: y.sum().backward())
    else:
        cl = torch.channels_last
        got = grad(x.to(memory_format=cl), lambda y: y.backward(gy.bfloat16().to(memory_format=cl)))
    want = grad(x, lambda y: y.backward(gy.bfloat16()))
    assert got.dtype == torch.float64 and torch.equal(got, want)


# --- the launch plan ---------------------------------------------------------


def test_res15s_plan_is_seven_m_tiles_of_eight_channels_and_one_n_tile_of_48():
    p = plan(45, 45, 3, 3, 101, 40, 101, 40)
    assert (p["m_tiles"], p["n_tiles"], p["nn"], p["nch"], p["stages"]) == (7, 1, 6, 8, 64)
    assert p["smem"] == 4 * 6 * 1024 + 64 * KC * 4 + 8 * 101 * 40 * 2 + 16 == 105_616
    assert 2 * (p["smem"] + 1024) <= 233_472  # two CTAs an SM


@pytest.mark.parametrize("o,n_tiles,nn", [(1, 1, 1), (19, 1, 3), (45, 1, 6), (64, 1, 8), (65, 2, 5), (94, 2, 6),
                                          (186, 3, 8), (336, 6, 7)])
def test_the_n_tiles_are_the_fewest_of_at_most_64_columns(o, n_tiles, nn):
    p = plan(1, o, 3, 3, 10, 10, 8, 8)
    assert (p["n_tiles"], p["nn"]) == (n_tiles, nn) and o <= n_tiles * nn * 8 < o + 8 * n_tiles


def _conv_shapes(conf):
    """(layer, input shape, output shape) of every conv of a float32 ``conf`` model at B=2."""
    model = find_model(conf)(find_config(conf)).train()  # the training forward runs every conv
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, i[0].shape, o.shape)))
             for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(torch.randn(2, 101, 40), dropout=torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    return seen


@pytest.mark.parametrize("conf", [t.value for t in ConfigType])
def test_every_conv_of_every_model_fits_the_kernel(conf):
    shapes = _conv_shapes(conf)
    assert shapes
    for layer, (_, c, h, w), (_, o, ho, wo) in shapes:
        kh, kw = layer.kernel_size
        p = plan(c, o, kh, kw, h, w, ho, wo)
        assert p["smem"] <= wgrad_kernel.MAX_SMEM and max(h, w) < wgrad_kernel.MAX_SIDE, (conf, layer, p)


# --- the kernel's addressing, emulated ---------------------------------------


def emulate(gy, x, shape, geometry):
    """The kernel's partials as its addressing reads the operands, in float64: the position table
    packed to 16 bits a coordinate and unpacked, each M tile's copied channels read at a row's
    offset plus a position's (0 outside the input, and for padding rows and positions), and each
    B stage stored as the kernel's core-matrix rows and read back where wgmma's descriptor reads."""
    (sh, sw), (ph, pw), (dh, dw) = geometry
    b_, c, h, w = x.shape
    o, _, kh, kw = shape
    ho, wo = gy.shape[2:]
    p = plan(c, o, kh, kw, h, w, ho, wo)
    khw, hw, n_pos = kh * kw, h * w, ho * wo
    rows, nt = c * khw, p["nn"] * 8
    pos = torch.arange(p["stages"] * KC)
    ys = torch.where(pos < n_pos, pos // wo * sh - ph, -16384)
    xs = torch.where(pos < n_pos, pos % wo * sw - pw, 0)
    packed = ((ys & 0xFFFF) << 16) | (xs & 0xFFFF)
    ys, xs = (packed >> 16).to(torch.int16).long(), (packed & 0xFFFF).to(torch.int16).long()
    # B: item (n, kg) of a stage stored at the kernel's byte offset; wgmma reads B[k][n] of chunk q at
    # q * nt * 32 + (n // 8) * 256 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2.
    n, kg, kk = torch.meshgrid(torch.arange(nt), torch.arange(KC // 8), torch.arange(8), indexing="ij")
    store = ((kg >> 1) * nt * 32 + (n >> 3) * 256 + (kg & 1) * 128 + (n & 7) * 16 + kk * 2) // 2
    k, n2 = torch.meshgrid(torch.arange(KC), torch.arange(nt), indexing="ij")
    read = ((k // 16) * nt * 32 + (n2 >> 3) * 256 + (k % 16 // 8) * 128 + (n2 & 7) * 16 + (k % 8) * 2) // 2
    out = torch.zeros((b_, o, rows), dtype=torch.float64)
    for b in range(b_):
        for m_tile in range(p["m_tiles"]):
            m0 = m_tile * 64
            c_lo = m0 // khw
            nch = (min(rows, m0 + 64) - 1) // khw - c_lo + 1
            assert nch <= p["nch"]
            slab = x[b, c_lo:c_lo + nch].reshape(-1).double()
            r = m0 + torch.arange(64)
            tap = r % khw
            ri = torch.where(r < rows, tap // kw * dh, -(1 << 20))
            rj = torch.where(r < rows, tap % kw * dw, 0)
            roff = torch.where(r < rows, (r // khw - c_lo) * hw + ri * w + rj, 0)
            y, xx = ys[None] + ri[:, None], xs[None] + rj[:, None]
            ok = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
            addr = torch.where(ok, (ys * w + xs)[None] + roff[:, None], 0)
            a = torch.where(ok, slab[addr], 0.0)  # (64, stages * KC)
            for n_tile in range(p["n_tiles"]):
                n0 = n_tile * nt
                acc = torch.zeros((64, nt), dtype=torch.float64)
                for s in range(p["stages"]):
                    o_, p_ = n0 + n, s * KC + kg * 8 + kk
                    val = torch.zeros(n.shape, dtype=torch.float64)
                    inside = (o_ < o) & (p_ < n_pos)
                    val[inside] = gy[b].reshape(o, n_pos)[o_[inside], p_[inside]].double()
                    buf = torch.zeros(nt * KC, dtype=torch.float64)
                    buf[store.reshape(-1)] = val.reshape(-1)
                    acc += a[:, s * KC:(s + 1) * KC] @ buf[read]
                keep_r, keep_o = min(64, rows - m0), min(nt, o - n0)
                out[b, n0:n0 + keep_o, m0:m0 + keep_r] = acc[:keep_r, :keep_o].t()
    return out


@pytest.mark.parametrize("geometry", COLUMN_GEOMETRIES + [CARD_GEOMETRIES[k] for k in (
    "res8-conv1", "res15-d16", "cnn-trad-pool2-conv2")], ids=geometry_id)
def test_the_kernels_addressing_gives_the_plain_partials_exactly(geometry):
    x, gy, shape, geo = operands(geometry, 2, seed=1, integers=True)
    if geometry[0] > 1:
        x[:, 1] = 0  # a dead input channel
    want = conv_wgrad(gy, x, shape, geo)
    got = emulate(gy, x, shape, geo)
    assert torch.equal(got, want.double())


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CARD_GEOMETRIES))
def test_each_samples_partial_is_the_same_bits_at_any_row_count(card, name):
    x, gy, shape, geo = operands(CARD_GEOMETRIES[name], 256, seed=2, device=card)
    before = wgrad_kernel.launches
    whole = conv_wgrad(gy, x, shape, geo)
    assert wgrad_kernel.launches == before + 1
    for rows in (4, 8, 16, 64):
        parts = torch.cat([conv_wgrad(gy[i:i + rows], x[i:i + rows], shape, geo) for i in range(0, 256, rows)])
        assert torch.equal(parts, whole), f"{rows} rows: {int((parts != whole).sum())} elements apart"


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CARD_GEOMETRIES))
def test_each_partial_is_within_one_rounding_a_term_of_its_float64_truth(card, name):
    x, gy, shape, geo = operands(CARD_GEOMETRIES[name], 16, seed=3, device=card)
    if shape[1] > 1:
        x[:, 0] = 0  # a dead input channel
    got = conv_wgrad(gy, x, shape, geo).double()
    cols = layers._columns(x, shape, gy.shape[2:], geo).double()
    truth = torch.bmm(gy.double().flatten(2), cols.transpose(1, 2))
    scale = torch.bmm(gy.double().abs().flatten(2), cols.abs().transpose(1, 2))
    n_terms = gy.shape[2] * gy.shape[3]
    assert bool(((got - truth).abs() <= n_terms * 2.0 ** -24 * scale).all())
    if shape[1] > 1:
        khw = shape[2] * shape[3]
        assert bool((got[:, :, :khw] == 0).all())
