"""A CPU model of the standard masked-GEMM tile's arithmetic
(``src/repro_torch/csrc/masked_matmul.cu``, ``masked_gemm_kernel``): one
f32 product as three TF32 tensor-core products, and its rule for
non-finite operands.

The tensor cores read the top 19 bits of each 32-bit operand (``tc``).
The kernel splits each operand x into hi = x rounded to the nearest TF32
and lo = x - hi (exact in f32), and adds lo·hi + hi·lo + hi·hi into an f32
accumulator, one m16n8k8 product (8 terms, each a single rounding here) at
a time, flushed into a second f32 sum every FLUSH_STEPS k8 steps.  Where a
k8 step holds a non-finite value it splits with ``split_exact``.  The model
repeats that in int32 bit operations and float64 products on torch
tensors.  It lives here only: no wrapper and no CPU path calls it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TF32_MASK = -8192              # 0xffffe000: sign, exponent, 10 bits
SIGN = -2 ** 31                # 0x80000000
MIN_NORMAL = 0x00800000
INF = 0x7F800000
CANONICAL_NAN = 0x7FC00000
FLUSH_STEPS = 8


def bits(x):
    return x.view(torch.int32)


def value(u):
    return u.view(torch.float32)


def tc(x):
    """What the tensor cores read of an f32 operand."""
    return value(bits(x) & TF32_MASK)


def split_fast(x):
    """(hi, hi for the correction products, lo): hi rounded to the nearest
    TF32, ties away from 0."""
    hi = value((bits(x) + 0x1000) & TF32_MASK)
    return hi, hi, x - hi


def split_exact(x):
    """The kernel's split where a k8 step holds a non-finite value: hi
    truncated; a non-finite x is its own hi (a NaN the canonical NaN) with
    lo = 0 and a correction hi of 0; a subnormal x takes the smallest
    normal of its sign as hi."""
    u = bits(x)
    v = u & 0x7FFFFFFF
    nonfinite = v >= INF
    sub = (v != 0) & (v < MIN_NORMAL)
    hi = torch.where(sub, (u & SIGN) | MIN_NORMAL, u & TF32_MASK)
    hi = torch.where(nonfinite, torch.where(v > INF, CANONICAL_NAN, u), hi)
    hi = value(hi.to(torch.int32))
    lo = torch.where(nonfinite, torch.zeros_like(x), x - hi)
    hic = torch.where(nonfinite, torch.zeros_like(x), hi)
    return hi, hic, lo


def products(x, y):
    """Σ_k tc(x)·tc(y) of one k8 step in float64, inf and NaN as IEEE
    products give them (broadcast, not a BLAS call)."""
    return (tc(x).double()[:, :, None] * tc(y).double()[None]).sum(1)


def tile(a, b, split=split_fast, terms=3):
    """The tile's sum of a (M, K) @ (K, N) f32 product: per k8 step the
    ``terms`` products (3: lo·hi, hi·lo, hi·hi; 1: the f32 operands as the
    tensor cores read them) each added into the f32 part sum with one
    rounding, the part sum added into the f32 total every FLUSH_STEPS
    steps."""
    m, k = a.shape
    n = b.shape[1]
    pad = -k % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, ac, al = split(a)
    bh, bc, bl = split(b)
    total = torch.zeros(m, n, dtype=torch.float32)
    part = torch.zeros(m, n, dtype=torch.float32)
    steps = a.shape[1] // 8
    for s in range(steps):
        ks = slice(8 * s, 8 * s + 8)
        pairs = ((al, bc), (ac, bl), (ah, bh)) if terms == 3 else ((a, b),)
        for x, y in pairs:
            part = (part.double() + products(x[:, ks], y[ks])).float()
        if (s + 1) % FLUSH_STEPS == 0 or s + 1 == steps:
            total = total + part
            part = torch.zeros_like(part)
    return total


def operands(m, k, n, seed, spread=0.0):
    """f32 normals, each row of A and column of B scaled by 10^U(-spread,
    spread)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) * 10.0 ** rng.uniform(-spread, spread,
                                                          (m, 1))
    b = rng.standard_normal((k, n)) * 10.0 ** rng.uniform(-spread, spread,
                                                          (1, n))
    return (torch.tensor(a, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32))


@pytest.mark.parametrize("m,k,n,spread", [(16, 4096, 16, 0.0),
                                          (24, 33, 40, 3.0),
                                          (32, 1000, 24, 1.0)])
def test_three_tf32_products_reach_f32_accuracy(m, k, n, spread):
    a, b = operands(m, k, n, seed=k, spread=spread)
    want = a.double() @ b.double()
    scale = float(want.abs().max())
    got = tile(a, b)
    assert float((got.double() - want).abs().max()) <= 4e-6 * scale
    # one TF32 product (the truncated operands alone) is not within 1e-4
    one = tile(a, b, terms=1)
    assert float((one.double() - want).abs().max()) > 1e-4 * scale


def _planted():
    """A (16, 24) and B (24, 16) with ±inf and a NaN whose payload lies in
    its low 13 bits in A, meeting TF32-exact partners (1.5, 0.0), a
    subnormal and normal values in B."""
    a, b = operands(16, 24, 16, seed=5)
    a[2, 3] = float("inf")
    a[7, 3] = float("-inf")
    a[11, 9] = value(torch.tensor([0x7F800001], dtype=torch.int32))[0]
    b[3, 0], b[3, 1], b[3, 2], b[3, 3] = 1.5, 0.0, 1e-40, -0.5
    b[9, 5] = 0.0
    return a, b


def test_non_finite_rule_puts_inf_and_nan_where_f32_does():
    a, b = _planted()
    assert bool(b[3, 2] != 0) and float(b[3, 2].abs()) < 1.2e-38
    want = (a.double()[:, :, None] * b.double()[None]).sum(1)
    assert int(want.isinf().sum()) > 0 and int(want.isnan().sum()) > 0
    got = tile(a, b, split=split_exact)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got == float("inf"), want == float("inf"))
    fin = want.isfinite()
    assert float((got[fin].double() - want[fin]).abs().max()) <= \
        4e-6 * float(want[fin].abs().max())


def test_the_plain_split_misplaces_non_finite_values():
    """Without the rule: inf - inf makes lo NaN, and inf · 0 (lo of a
    TF32-exact partner) makes a NaN where f32 gives inf; a NaN kept with
    its payload is read as inf by the tensor cores."""
    a, b = _planted()
    want = (a.double()[:, :, None] * b.double()[None]).sum(1)
    naive = tile(a, b, split=split_fast)
    assert not torch.equal(naive.isnan(), want.isnan())
    assert bool(want[2, 0].isinf()) and bool(naive[2, 0].isnan())

    def payload_kept(x):
        hi, hic, lo = split_exact(x)
        nan = x.isnan()
        return torch.where(nan, x, hi), hic, lo
    kept = tile(a, b, split=payload_kept)
    assert bool(want[11, 0].isnan()) and not bool(kept[11, 0].isnan())
