"""The f32 tensor-core GEMM (ops/gemm.py, csrc/gemm_f32.cu) and its route
from models/layers.py::linear, on the CPU: the kernel's arithmetic modelled
in numpy against f64 products, the routing predicate, and the autograd
Function with the plain matmul in the kernel's place. One test holds the
kernel itself against f64 on a card (marker ``cuda``; it skips here).

Tolerances: the JAX f32 ones (tests/test_attention_kernel.py's forward),
rtol 1e-4 / atol 1e-5, at the scales of the layers' operands: activations
of unit scale (LayerNorm's output), BERT's initial weights N(0, 0.02), and
output gradients of that scale.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eeg_multimodal_torch.models import layers as L
from eeg_multimodal_torch.ops import gemm as G

TOL = dict(rtol=1e-4, atol=1e-5)
SMS = 132  # the H100's SMs: the split-K share the card would take


def tf32_hi(x):
    """The kernel's tf32_hi: x with its 13 low mantissa bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to TF32, ties away from zero, low bits
    cleared."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def trunc_f32(x):
    """f64 values cut to f32 toward zero, as the tensor core's f32
    accumulation truncates."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def stage_steps(k0, K):
    """The reduction indices of each k8 step of the stage at k0, in the
    kernel's order: step ks holds 2 ks + h + 8 j (h = 0, 1; j = 0 .. 3),
    indices past K dropped (zeros in the tiles)."""
    return [[k for k in (k0 + 2 * ks + h + 8 * j for j in range(4) for h in range(2)) if k < K]
            for ks in range(G.STAGE_K // 8)]


def gemm_model(a, b, splits=1, flush=2, passes=3):
    """a @ b as the kernel computes it: split-K's shares of the stages of 32
    indices, each share in stages whose products go to a partial sum, each
    k8 step's 8 products exact and the partial truncated to f32 after it,
    hi.lo and lo.hi before hi.hi in each stage (``passes=1``: hi.hi alone);
    the partial, fresh every ``flush`` stages of its share, added to the
    share's running f32 sum (rounded to nearest); the shares' sums added in
    their order."""
    a_hi, b_hi = tf32_hi(a), tf32_hi(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    terms = ([(a_hi, b_lo), (a_lo, b_hi)] if passes == 3 else []) + [(a_hi, b_hi)]
    K = a.shape[1]
    stages = -(-K // G.STAGE_K)
    chunks = -(-stages // splits)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for z in range(0, stages, chunks):
        run = np.zeros_like(total)
        part = np.zeros_like(total)
        for i, st in enumerate(range(z, min(z + chunks, stages))):
            if i % flush == 0:
                part[:] = 0
            for x, y in terms:
                for ks in stage_steps(st * G.STAGE_K, K):
                    part = trunc_f32(part.astype(np.float64)
                                     + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
            if (i + 1) % flush == 0 or st + 1 == min(z + chunks, stages):
                run = (run + part).astype(np.float32)
        total = (total + run).astype(np.float32)
    return total


# (M, K, N): BERT-base at batch 8, S = 512 (the packed QKV, the FFN's output)
# and the decoder's K / V projection at batch 8, S = 80
SHAPES = [(4096, 768, 2304), (4096, 3072, 768), (640, 768, 768)]


def sampled_operands(layout, M, K, N, rng, n=48):
    """The operands of n sampled rows and n sampled columns of C for the
    layer (M, K) @ (K, N) in ``layout``, each output element's reduction as
    long as the full product's (the element depends on its row of A and
    column of B alone): the forward x (unit scale) @ kernel (BERT's
    N(0, 0.02)); dX = dY @ kernel^T, dY at 0.02; dW = x^T @ dY."""
    x = lambda rows, cols: rng.standard_normal((rows, cols)).astype(np.float32)
    if layout == G.FWD:
        return x(n, K), x(K, n) * np.float32(0.02), (M, N, K)
    if layout == G.DX:
        return x(n, N) * np.float32(0.02), x(N, n) * np.float32(0.02), (M, K, N)
    return x(n, M), x(M, n) * np.float32(0.02), (K, N, M)


@pytest.mark.parametrize("layout", [G.FWD, G.DX, G.DW], ids=["fwd", "dX", "dW"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_3xtf32_split_holds_the_jax_tolerances_and_plain_tf32_does_not(shape, layout):
    """The kernel's product arithmetic (hi truncated, lo rounded to TF32, the
    three products with the small terms first, each k8 step's sum truncated
    to f32, partials of two stages added in f32, the split-K share the card
    takes at this shape) at BERT's and the decoder's shapes, in the three
    layouts, against f64: within rtol 1e-4 / atol 1e-5. Plain TF32 (the
    operands rounded to TF32, the sum exact) misses them, so the check tells
    a split that is too lossy."""
    rng = np.random.default_rng(sum(shape) + layout)
    a, b, dims = sampled_operands(layout, *shape, rng)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = gemm_model(a, b, splits=G.splits_for(*dims, SMS))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - want).max() < 4e-6 * max(1.0, np.abs(want).max())
    tf32 = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert (np.abs(tf32 - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)).any()


def test_split_k_shares_and_flushes_keep_the_tolerances():
    """Every split-K share the C interface deals (1 to 8) and a partial sum
    over one stage or four hold the tolerances at the weight gradient's
    4096-row reduction."""
    rng = np.random.default_rng(7)
    a, b, _ = sampled_operands(G.DW, 4096, 768, 768, rng, n=16)
    want = a.astype(np.float64) @ b.astype(np.float64)
    for splits in range(1, G.MAX_SPLITS + 1):
        np.testing.assert_allclose(gemm_model(a, b, splits=splits), want, **TOL)
    for flush in (1, 4):
        np.testing.assert_allclose(gemm_model(a, b, flush=flush), want, **TOL)


def test_stage_steps_deal_each_index_once():
    """A stage's 4 k8 steps hold its 32 indices once each, 8 a step; thread
    t's k-slots t and t + 4 over the steps are its 8 indices 8 t .. 8 t + 7
    (the two 16-byte loads of its A rows); B's chunk c holds c + 8 j."""
    steps = stage_steps(0, 32)
    assert sorted(k for st in steps for k in st) == list(range(32))
    for ks, st in enumerate(steps):
        slot = {s: (8 * s + 2 * ks if s < 4 else 8 * (s - 4) + 2 * ks + 1) for s in range(8)}
        assert sorted(slot.values()) == sorted(st)
        for t in range(4):
            assert {slot[t], slot[t + 4]} <= set(range(8 * t, 8 * t + 8))
        for h in range(2):  # chunk 2 ks + h: slots 4 h .. 4 h + 3
            assert [slot[4 * h + j] for j in range(4)] == [2 * ks + h + 8 * j for j in range(4)]
    assert stage_steps(32, 40) == [[32, 33], [34, 35], [36, 37], [38, 39]]


@pytest.mark.parametrize("M,N,K", [(4096, 2304, 768), (4096, 768, 3072), (768, 2304, 4096),
                                   (768, 768, 4096), (640, 768, 768), (768, 768, 640),
                                   (48640, 768, 768), (1001, 768, 768)])
def test_splits_for_deals_as_the_c_interface(M, N, K):
    """The split-K share is one that the C interface keeps (it deals the
    stages evenly and uses ceil(stages / ceil(stages / s)) shares), at most
    MAX_SPLITS, and leaves every share a stage."""
    s = G.splits_for(M, N, K, SMS)
    stages = -(-K // G.STAGE_K)
    chunks = -(-stages // s)
    assert 1 <= s <= G.MAX_SPLITS and -(-stages // chunks) == s
    assert (s - 1) * chunks < stages


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

@pytest.fixture
def counts():
    G.gemm_f32.reset()
    yield G.gemm_f32
    G.gemm_f32.reset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,kshape", [((2, 80, 768), (768, 2304)), ((640, 768), (768, 768)),
                                           ((8, 2304), (2304, 2304)), ((10, 4, 16), (5, 16, 8))])
def test_linear_on_the_cpu_is_unchanged(xshape, kshape, dtype, counts):
    """On the CPU ``linear`` is ``F.linear`` (or the stacked baddbmm) as
    before, bit for bit, in f32 and under the bf16 cast; nothing is routed
    or counted as declined."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(xshape, generator=g).to(dtype)
    kernel = (torch.randn(kshape, generator=g) * 0.02).to(dtype)
    bias = torch.randn(kshape[:-2] + kshape[-1:], generator=g).to(dtype)
    got = L.linear({"kernel": kernel, "bias": bias}, x)
    if kernel.dim() == 3:
        want = torch.baddbmm(bias.unsqueeze(1), x.reshape(kshape[0], -1, kshape[1]), kernel)
        want = want.reshape(*xshape[:-1], kshape[-1])
    else:
        want = F.linear(x, kernel.t(), bias)
    assert got.dtype == dtype and torch.equal(got, want)
    assert counts.launches == 0 and counts.declined == 0


def offset(t, n=1):
    """t's values in memory that starts ``n`` elements past an aligned
    allocation: the same strides, a data pointer off the 16-byte grid."""
    out = torch.empty(t.numel() + n, dtype=t.dtype)[n:].view(t.shape)
    return out.copy_(t)


def test_the_route_takes_the_large_f32_products_and_declines_the_rest(counts):
    """``decline`` accepts BERT's f32 products and the decoder's K / V
    projections at S = 512 and in the eval (a column slice of the
    in-projection, its bias a slice), and declines: bf16 on either side
    ("dtype"), a stacked kernel ("stacked"), the products under the floor
    ("floor": the one-token ones, the decoder's K / V at 8 x 80 rows), and
    operands the kernel would need copied ("alignment": a pointer off the
    16-byte grid, a width no multiple of 4, a row stride that is not, a 3-D
    x that is no view of rows). ``takes`` never routes a CPU tensor, nor
    counts it."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = torch.empty(8, 512, 768)
    w, b = torch.empty(768, 2304), torch.empty(2304)
    in_proj, in_bias = torch.empty(768, 2304), torch.empty(2304)
    kv, kv_b = in_proj[:, 768:1536], in_bias[768:1536]
    assert G.decline(x, w, b) is None
    assert G.decline(torch.empty(4096, 768), kv, kv_b) is None
    assert G.decline(torch.empty(48640, 768), kv, kv_b) is None
    assert G.decline(torch.empty(640, 768), kv, kv_b) == "floor"
    assert G.decline(torch.empty(1024, 768), kv, kv_b) is None
    assert G.decline(torch.empty(4096, 3072), torch.empty(3072, 768), torch.empty(768)) is None
    assert G.decline(x.to(bf16), w, b) == "dtype"
    assert G.decline(x, w.to(bf16), b.to(bf16)) == "dtype"
    assert G.decline(x, torch.empty(5, 768, 2304), torch.empty(5, 2304)) == "stacked"
    assert G.decline(torch.empty(8, 1, 768), kv, kv_b) == "floor"
    assert G.decline(torch.empty(8, 2304), torch.empty(2304, 2304), torch.empty(2304)) == "floor"
    assert G.decline(offset(torch.zeros(4096, 768)), w, b) == "alignment"
    assert G.decline(torch.empty(4096, 768), offset(torch.zeros(768, 2304)), b) == "alignment"
    assert G.decline(torch.empty(4096, 770), torch.empty(770, 2304), b) == "alignment"
    assert G.decline(torch.empty(4096, 772)[:, :768], w, b) is None  # a row stride of 772
    assert G.decline(torch.empty(4096, 770)[:, :768], w, b) == "alignment"
    assert G.decline(torch.empty(512, 8, 768).transpose(0, 1), w, b) == "alignment"
    assert G.decline(x, w, offset(torch.zeros(2304))) == "alignment"
    assert G.decline(x, w, None) == "alignment"
    assert not G.takes(x, w, b) and counts.declined == 0


def test_the_route_counts_the_declined_products_on_the_card(counts, monkeypatch):
    """``takes`` on (what reads as) the card: an f32 2-D product under the
    floor or misaligned counts in ``declined``, a bf16 or stacked one does
    not, and a routed one is taken."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    w, b = torch.empty(768, 768), torch.empty(768)
    assert G.takes(torch.empty(4096, 768), w, b)
    assert not G.takes(torch.empty(8, 768), w, b)
    assert not G.takes(offset(torch.zeros(4096, 768)), w, b)
    assert not G.takes(torch.empty(4096, 768, dtype=torch.bfloat16), w, b)
    assert not G.takes(torch.empty(4096, 768), torch.empty(2, 768, 768), torch.empty(2, 768))
    assert counts.declined == 2 and counts.launches == 0


def leaves(*shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).requires_grad_() for s in shapes]


@pytest.mark.parametrize("xshape", [(6, 16), (2, 5, 16)])
@pytest.mark.parametrize("sliced", [False, True])
def test_linear_f32_and_its_backward_equal_f_linear_with_the_plain_matmul(xshape, sliced):
    """``linear_f32`` on the CPU (``gemm_plain`` in the kernel's three
    places) gives F.linear's output and autograd's gradients of F.linear
    for x, the kernel and the bias; also with a kernel that is a column
    slice (the decoder's K / V projection) and a 3-D x."""
    x, w_full, b_full = leaves(xshape, (16, 24), (24,))
    w, b = (w_full[:, 8:16], b_full[8:16]) if sliced else (w_full, b_full)
    g = torch.randn(*xshape[:-1], w.shape[1], generator=torch.Generator().manual_seed(1))
    got = G.linear_f32(x, w, b)
    want = F.linear(x, w.t(), b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    got_g = torch.autograd.grad(got, (x, w_full, b_full), g)
    want_g = torch.autograd.grad(want, (x, w_full, b_full), g)
    for name, u, v in zip(("x", "kernel", "bias"), got_g, want_g):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6, msg=lambda m: f"d{name}: {m}")


def test_linear_f32_leaves_out_the_gradients_nobody_needs():
    """A frozen kernel and bias get no gradient computed; without a
    gradient to record the forward runs without the Function."""
    x, w, b = leaves((4, 8), (8, 12), (12,))
    w.requires_grad_(False)
    b.requires_grad_(False)
    y = G.linear_f32(x, w, b)
    assert y.grad_fn is not None
    (dx,) = torch.autograd.grad(y, (x,), torch.ones_like(y))
    torch.testing.assert_close(dx, torch.ones(4, 12) @ w.t())
    with torch.no_grad():
        assert G.linear_f32(x, w, b).grad_fn is None


@pytest.mark.parametrize("layout", [G.FWD, G.DX, G.DW])
def test_gemm_plain_is_the_layouts_product(layout):
    """``gemm_plain`` and ``dims`` per layout: a @ b, a @ b^T, a^T @ b."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(6, 4, generator=g, dtype=torch.float64)
    b = {G.FWD: (4, 5), G.DX: (5, 4), G.DW: (6, 5)}[layout]
    b = torch.randn(b, generator=g, dtype=torch.float64)
    want = {G.FWD: lambda: a @ b, G.DX: lambda: a @ b.T, G.DW: lambda: a.T @ b}[layout]()
    assert torch.equal(G.gemm_plain(layout, a, b), want)
    assert G.dims(layout, a, b) == (*want.shape, {G.FWD: 4, G.DX: 4, G.DW: 6}[layout])


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_the_kernel_holds_f64_products_on_the_card():
    """The kernel in its three layouts against f64 products, at a ragged M
    (1001 rows, no multiple of the 128-row tile; the weight gradient's
    reduction odd) with the bias, within the tolerances, and every split-K
    share bit for bit the same on a repeat; the autograd Function's gradients
    the same for an output gradient off the 16-byte grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(3)
    M, K, N = 1001, 768, 384
    x = torch.randn(M, K, generator=g, device=dev)
    w = torch.randn(K, N, generator=g, device=dev) * 0.02
    b = torch.randn(N, generator=g, device=dev) * 0.02
    dy = torch.randn(M, N, generator=g, device=dev) * 0.02
    for layout, a, bb, bias in ((G.FWD, x, w, b), (G.DX, dy, w, None), (G.DW, x, dy, None)):
        want = G.gemm_plain(layout, a.double(), bb.double(),
                            None if bias is None else bias.double())
        for splits in range(1, G.MAX_SPLITS + 1):
            got = G.gemm_f32(a, bb, bias, layout, splits=splits)
            torch.testing.assert_close(got.double(), want, **TOL)
            assert torch.equal(got, G.gemm_f32(a, bb, bias, layout, splits=splits))
    odd = torch.empty(dy.numel() + 1, device=dev)[1:].view_as(dy)  # off the 16-byte grid
    odd.copy_(dy)
    grads = []
    for g in (dy, odd):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        grads.append(torch.autograd.grad(G.linear_f32(*leaves), leaves, g))
    assert not G.loadable(odd) and all(torch.equal(u, v) for u, v in zip(*grads))
