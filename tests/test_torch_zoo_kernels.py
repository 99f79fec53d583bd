"""The model zoo's two kernel modules against the reference's kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the reference Pallas kernel run as ``tests/test_kernels.py`` and
``tests/test_kernels_rmsnorm.py`` run it (the Pallas interpreter) and
against the reference's oracle.  The hand-written CUDA kernels are held
against those plain versions on the card (``cuda`` tests, skipped where
there is none; ``chip_smoke.py`` does the same at the main path's
shapes).  The reference is imported inside the ``ref`` fixture, so the
card tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest tests/test_torch_zoo_kernels.py -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.kernels import lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_plain,
    check_tma_operands,
    flash_attention,
    route,
)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    REGISTER_ROW_BYTES,
    SPREAD_ROWS,
    launch_plan,
    rmsnorm,
    rmsnorm_plain,
)

EPS = 1e-5  # the reference kernels' default


@pytest.fixture
def ref():
    """The reference kernels and oracles (the tests that compare against
    them skip where JAX is missing)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
    from repro.kernels.rmsnorm.ref import rmsnorm_ref

    return SimpleNamespace(
        jnp=jnp,
        rmsnorm=jax_rmsnorm,
        rmsnorm_ref=rmsnorm_ref,
        flash=jax_flash,
        attention_ref=attention_ref,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- rmsnorm ---------------------------------------------------------------------
# the shapes of tests/test_kernels_rmsnorm.py; bf16 inputs are rounded from
# the same float32 numbers on both sides (round to nearest even in both)
@pytest.mark.parametrize("shape", [(8, 64), (2, 16, 128), (5, 96), (1, 256)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_rmsnorm_matches_reference_kernel_and_oracle(ref, rng, shape, dtype, atol):
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    xj = ref.jnp.asarray(x, getattr(ref.jnp, dtype))
    want_kernel = ref.rmsnorm(xj, ref.jnp.asarray(scale), block_rows=4)
    want_oracle = ref.rmsnorm_ref(xj, ref.jnp.asarray(scale))
    before = rmsnorm.launches
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = rmsnorm(xt, torch.from_numpy(scale), EPS)
    assert rmsnorm.launches == before  # CPU: the plain version, no launch
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=atol)


def test_rmsnorm_rejects_bad_operands(rng):
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(7), EPS)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(8, dtype=torch.float64), EPS)
    with pytest.raises(TypeError):
        rmsnorm(x.double(), torch.ones(8), EPS)
    with pytest.raises(ValueError):
        rmsnorm(x.t().contiguous().t(), torch.ones(8), EPS)  # not contiguous


def test_rmsnorm_never_falls_back_off_the_cpu(rng):
    """Mixed devices are refused; ``meta`` (the planner's shapes) takes the
    plain version like the CPU; any other device that is not CUDA raises."""
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="different devices"):
        rmsnorm(x.to("meta"), torch.ones(8), EPS)
    before = dict(rmsnorm.launches_by_route)
    out = rmsnorm(x.to("meta"), torch.ones(8, device="meta"), EPS)
    assert out.device.type == "meta" and out.shape == x.shape
    assert rmsnorm.launches_by_route == before
    other = SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        lib.device_index("rmsnorm", other, other)


# rows of d * elem bytes: 16-byte multiples up to 16 KB are held in
# registers on the cta route, 128 threads a row when they hold it and the
# rows fill the card, else 256; the rest take the masked route
@pytest.mark.parametrize("n", [1, 4, 4000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1000, 1001, 3840, 8192, 8200])
def test_rmsnorm_launch_plan(n, dtype, d):
    elem = torch.finfo(dtype).bits // 8
    row = d * elem
    way, threads, rows_per_cta, vec = launch_plan(n, d, elem)
    assert vec == (row % 16 == 0)
    if not vec or row > REGISTER_ROW_BYTES:
        assert way == "masked"
        assert (threads, rows_per_cta) == (32, 8)
    else:
        assert way == "cta" and rows_per_cta == 1
        assert threads * 4 * 16 >= row  # 4 vectors of 16 bytes a thread
        narrow = n >= SPREAD_ROWS and 128 * 4 * 16 >= row
        assert threads == (128 if narrow else 256)
    # the zoo's shapes: prefill [4000, 3840] and decode [4, 3840] in bf16
    if (d, dtype) == (3840, torch.bfloat16):
        assert (way, threads) == ("cta", 128 if n == 4000 else 256)
    # 8192 bf16 (the reference's largest) is held; 8200 bf16 is not
    if dtype == torch.bfloat16 and d in (8192, 8200):
        assert (way == "masked") == (d == 8200)


@pytest.mark.parametrize("d,elem", [(3840, 2), (1000, 4), (64, 2)])
def test_rmsnorm_launch_plan_unaligned_takes_the_masked_route(d, elem):
    for n in (4, 4000):
        assert launch_plan(n, d, elem, aligned=False) == ("masked", 32, 8, False)


# -- flash attention -------------------------------------------------------------
def _qkv(rng, b, s, hq, hkv, d):
    return (
        rng.standard_normal((b, s, hq, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
    )


def _check_attention(ref, arrays, dtype, atol, **kw):
    """The port's wrapper (plain version on the CPU) against the reference's
    Pallas kernel (interpreter, 64-row blocks as tests/test_kernels.py runs
    it) and its oracle, on the same inputs rounded to ``dtype`` alike."""
    jt = [ref.jnp.asarray(a, getattr(ref.jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want_kernel = ref.flash(*jt, causal=True, block_q=64, block_k=64, **kw)
    want_oracle = ref.attention_ref(*jt, causal=True, **kw)
    before = flash_attention.launches
    before_route = dict(flash_attention.launches_by_route)
    got = flash_attention(*tt, causal=True, **kw)
    assert flash_attention.launches == before
    assert flash_attention.launches_by_route == before_route
    assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=atol)


# the cases of tests/test_kernels.py at S <= 128: MHA / GQA 4:1 / MQA
@pytest.mark.parametrize(
    "b,s,hq,hkv,d", [(1, 128, 4, 4, 32), (2, 128, 8, 2, 16), (1, 128, 4, 1, 64)]
)
@pytest.mark.parametrize("window", [None, 64])
def test_attention_matches_reference(ref, rng, b, s, hq, hkv, d, window):
    _check_attention(ref, _qkv(rng, b, s, hq, hkv, d), "float32", 2e-5, window=window)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_attention_dtypes(ref, rng, dtype, atol):
    _check_attention(ref, _qkv(rng, 1, 128, 4, 2, 32), dtype, atol)


def test_attention_softcap(ref, rng):
    _check_attention(ref, _qkv(rng, 1, 128, 2, 2, 16), "float32", 2e-5, softcap=20.0)


def test_attention_uneven_length(ref, rng):
    """S = 96 is no multiple of the reference's 64-row blocks: it pads, the
    port's kernel masks the tail by the true length."""
    _check_attention(ref, _qkv(rng, 1, 96, 2, 2, 16), "float32", 2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_attention_head_dim_not_a_power_of_two(ref, rng, window):
    """head_dim 40 (h2o-danube-3-4b's is 120): no power of two assumed."""
    _check_attention(ref, _qkv(rng, 2, 80, 4, 2, 40), "float32", 2e-5, window=window)


def test_attention_rejects_bad_operands(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 16, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :8], v[:, :8])  # kv length differs
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)  # 3 q heads on 2 kv heads
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    big = torch.zeros(1, 4, 2, 136)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)  # head_dim above the kernel's 128


@pytest.mark.parametrize(
    "dtype,d,want",
    [
        (torch.bfloat16, 120, "wgmma"),  # h2o-danube-3-4b
        (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 40, "wgmma"),  # one 64-column half, zero-padded
        (torch.bfloat16, 8, "wgmma"),
        (torch.bfloat16, 36, "scalar"),  # rows of 72 bytes: no TMA
        (torch.bfloat16, 1, "scalar"),
        (torch.float32, 120, "scalar"),  # the reference's float32 arithmetic
        (torch.float32, 64, "scalar"),
    ],
)
def test_flash_attention_route(dtype, d, want):
    assert route(dtype, d) == want


def test_tma_operands_must_be_16_byte_aligned():
    """The tensor-core route's TMA maps want 16-byte aligned bases and
    rows: a contiguous view one element into its storage is refused."""
    shape = (1, 16, 2, 64)
    base = torch.zeros(2 * 16 * 64 + 8, dtype=torch.bfloat16)
    ok = base[: 2 * 16 * 64].view(shape)
    off = base[1 : 1 + 2 * 16 * 64].view(shape)
    assert ok.data_ptr() % 16 == 0 and off.is_contiguous()
    check_tma_operands(ok, ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        check_tma_operands(ok, off, ok)
    odd = torch.zeros(1, 16, 2, 36, dtype=torch.bfloat16)  # 72-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        check_tma_operands(odd)


# -- on the card -----------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,dtype,atol",
    [
        (4000, 3840, torch.bfloat16, 2e-2),
        (4, 3840, torch.bfloat16, 2e-2),
        (37, 1000, torch.float32, 1e-5),
        (37, 1001, torch.float32, 1e-5),  # no multiple of 16 bytes: scalar path
        (5, 1001, torch.bfloat16, 2e-2),
    ],
)
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rng, n, d, dtype, atol):
    x = torch.tensor(rng.standard_normal((n, d)), dtype=dtype, device=cuda)
    scale = torch.tensor(rng.standard_normal(d), dtype=torch.float32, device=cuda)
    before = rmsnorm.launches
    got = rmsnorm(x, scale, EPS)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(got, rmsnorm_plain(x, scale, EPS), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,dtype,window,softcap,atol",
    [
        (4, 1000, 32, 8, 120, torch.bfloat16, 4096, 0.0, 3e-2),  # zoo prefill
        (1, 4608, 32, 8, 120, torch.bfloat16, 4096, 0.0, 3e-2),  # window live
        (2, 333, 8, 2, 120, torch.float32, None, 30.0, 2e-5),
        (1, 97, 4, 1, 40, torch.float32, 16, 0.0, 2e-5),
        (1, 64, 1, 1, 64, torch.bfloat16, None, 0.0, 3e-2),  # a single tile
        (2, 1000, 8, 8, 120, torch.bfloat16, None, 0.0, 3e-2),  # group 1, tail
        (1, 130, 8, 2, 120, torch.bfloat16, None, 0.0, 3e-2),  # group 4, tail
        (1, 130, 8, 1, 120, torch.bfloat16, None, 0.0, 3e-2),  # group 8
        (2, 200, 4, 1, 64, torch.bfloat16, 48, 0.0, 3e-2),  # window inside a tile
        (1, 300, 4, 2, 128, torch.bfloat16, None, 30.0, 3e-2),  # bf16 softcap
        (2, 150, 4, 2, 40, torch.bfloat16, None, 0.0, 3e-2),  # one padded half
        (1, 150, 4, 2, 36, torch.bfloat16, None, 0.0, 3e-2),  # scalar route
    ],
)
def test_flash_attention_kernel_matches_plain_on_card(
    cuda, rng, b, s, hq, hkv, d, dtype, window, softcap, atol
):
    qa, ka, va = _qkv(rng, b, s, hq, hkv, d)
    # a different spread for every key, so that keys taken in the wrong
    # order inside a tile show in the output
    va = va * rng.uniform(0.25, 2.0, (1, s, 1, 1)).astype(np.float32)
    q, k, v = (torch.tensor(a, dtype=dtype, device=cuda) for a in (qa, ka, va))
    way = route(dtype, d)
    before = flash_attention.launches
    before_route = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route == {
        r: n + (r == way) for r, n in before_route.items()
    }
    want = attention_plain(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(got, want, atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,dtype,way,atol",
    [
        (4000, 3840, torch.bfloat16, "cta", 2e-2),  # zoo prefill
        (1500, 1000, torch.float32, "cta", 1e-5),
        (1024, 8192, torch.bfloat16, "cta", 2e-2),  # 16 KB rows, 256 threads
        (1024, 4096, torch.float32, "cta", 1e-5),
        (1030, 64, torch.bfloat16, "cta", 2e-2),
        (4, 3840, torch.bfloat16, "cta", 2e-2),  # zoo decode
        (1, 3840, torch.float32, "cta", 1e-5),  # 256 threads
        (37, 1000, torch.float32, "cta", 1e-5),
        (4, 8192, torch.bfloat16, "cta", 2e-2),
        (3, 24, torch.bfloat16, "cta", 2e-2),
        (37, 1001, torch.float32, "masked", 1e-5),  # no multiple of 16 bytes
        (5, 1001, torch.bfloat16, "masked", 2e-2),
        (6, 8200, torch.bfloat16, "masked", 2e-2),  # over 16 KB
        (2000, 8200, torch.float32, "masked", 1e-5),
    ],
)
def test_rmsnorm_each_route_matches_plain_on_card(cuda, rng, n, d, dtype, way, atol):
    x = torch.tensor(rng.standard_normal((n, d)) * 3.0, dtype=dtype, device=cuda)
    scale = torch.tensor(rng.standard_normal(d), dtype=torch.float32, device=cuda)
    before = dict(rmsnorm.launches_by_route)
    got = rmsnorm(x, scale, EPS)
    torch.cuda.synchronize()
    assert rmsnorm.launches_by_route == {
        r: k + (r == way) for r, k in before.items()
    }
    torch.testing.assert_close(got, rmsnorm_plain(x, scale, EPS), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_rmsnorm_unaligned_operand_takes_the_masked_route_on_card(cuda, rng):
    """A contiguous view one element past a 16-byte boundary."""
    flat = torch.tensor(
        rng.standard_normal(4 * 3840 + 1), dtype=torch.bfloat16, device=cuda
    )
    x = flat[1:].view(4, 3840)
    scale = torch.tensor(rng.standard_normal(3840), dtype=torch.float32, device=cuda)
    before = rmsnorm.launches_by_route["masked"]
    got = rmsnorm(x, scale, EPS)
    torch.cuda.synchronize()
    assert rmsnorm.launches_by_route["masked"] == before + 1
    torch.testing.assert_close(got, rmsnorm_plain(x, scale, EPS), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 4000])
def test_rmsnorm_side_stream_and_graph_replay_on_card(cuda, rng, n):
    """Launched on a side stream, and captured in a CUDA graph whose
    replay (after x changes in place) equals an eager call, bit for bit."""
    d = 3840
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.bfloat16, device=cuda)
    scale = torch.tensor(rng.standard_normal(d), dtype=torch.float32, device=cuda)
    want = rmsnorm(x, scale, EPS)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = rmsnorm(x, scale, EPS)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rmsnorm(x, scale, EPS)
    x.copy_(torch.tensor(rng.standard_normal((n, d)), dtype=torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, rmsnorm(x, scale, EPS))
    torch.testing.assert_close(
        captured, rmsnorm_plain(x, scale, EPS), atol=2e-2, rtol=2e-2
    )
