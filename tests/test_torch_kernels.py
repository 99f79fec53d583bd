"""The port's two kernel modules against the reference's kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the reference Pallas kernel run as ``tests/test_kernels.py``
runs it (the Pallas interpreter).  The hand-written CUDA kernels are
held against those plain versions on the card (``cuda`` tests, skipped
where there is none; ``chip_smoke.py`` does the same at the main path's
shapes).  The reference is imported inside the ``ref`` fixture, so the
card tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels.py -m cuda
"""

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.kernels import launch_cost, lib, rmsnorm  # noqa: E402
from repro_torch.kernels import replay_gather as gather_module  # noqa: E402
from repro_torch.kernels.fused_td import fused_td, fused_td_plain, td_loss  # noqa: E402
from repro_torch.kernels.replay_gather import (  # noqa: E402
    replay_gather,
    replay_gather_plain,
)


@pytest.fixture
def ref():
    """The reference kernels (the tests that compare against them skip
    where JAX is missing)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.fused_td.kernel import fused_td as jax_fused_td
    from repro.kernels.fused_td.ops import td_loss as jax_td_loss
    from repro.kernels.fused_td.ref import fused_td_ref
    from repro.kernels.replay_gather.ops import replay_gather as jax_gather

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        fused_td=jax_fused_td,
        td_loss=jax_td_loss,
        fused_td_ref=fused_td_ref,
        gather=jax_gather,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gather_inputs(rng, cap, feat, batch):
    buf = rng.standard_normal((cap, feat)).astype(np.float32)
    idx = rng.integers(0, cap, batch).astype(np.int32)
    w = rng.random(batch).astype(np.float32)
    return buf, idx, w


def _td_inputs(rng, b, a):
    q_sel = rng.standard_normal((b, 1)).astype(np.float32)
    q_next = rng.standard_normal((b, a)).astype(np.float32)
    r = rng.standard_normal((b, 1)).astype(np.float32)
    d = (rng.random((b, 1)) < 0.3).astype(np.float32)
    return q_sel, q_next, r, d


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


# the shapes of tests/test_kernels.py plus the fleet's row width at 8^3
@pytest.mark.parametrize(
    "cap,feat,batch", [(64, 16, 8), (256, 128, 32), (128, 33, 5), (4096, 1033, 128)]
)
def test_replay_gather_matches_reference_exactly(ref, rng, cap, feat, batch):
    buf, idx, w = _gather_inputs(rng, cap, feat, batch)
    want = np.asarray(ref.gather(buf, idx, w, mode="interpret"))
    before = replay_gather.launches
    got = replay_gather(*_t(buf, idx, w))
    assert replay_gather.launches == before  # CPU: plain version, no launch
    assert got.shape == (batch, feat)
    assert np.array_equal(got.numpy(), want)  # a copy and one multiply: exact


def test_replay_gather_rejects_bad_operands(rng):
    buf, idx, w = _t(*_gather_inputs(rng, 16, 8, 4))
    with pytest.raises(TypeError):
        replay_gather(buf, idx.long(), w)
    with pytest.raises(ValueError):
        replay_gather(buf, idx, w[:3])
    with pytest.raises(ValueError):
        replay_gather(buf.t(), idx, w)  # not contiguous


def test_replay_gather_never_falls_back_off_the_cpu(rng):
    """Operands on two devices are refused; a device that is neither the
    CPU nor CUDA raises instead of taking the plain version."""
    buf, idx, w = _t(*_gather_inputs(rng, 16, 8, 4))
    with pytest.raises(ValueError, match="different devices"):
        replay_gather(buf.to("meta"), idx, w)
    with pytest.raises(ValueError, match="different devices"):
        replay_gather(buf, idx, w.to("meta"))
    before = replay_gather.launches
    with pytest.raises(ValueError, match="unsupported device"):
        replay_gather(*(t.to("meta") for t in (buf, idx, w)))
    assert replay_gather.launches == before


# the shapes of tests/test_kernels.py, block_b = 32 as there
@pytest.mark.parametrize("b,a,gamma", [(64, 6, 0.9), (128, 4, 0.99), (32, 6, 0.5)])
def test_fused_td_matches_reference_kernel(ref, rng, b, a, gamma):
    ins = _td_inputs(rng, b, a)
    l_ref, dq_ref = ref.fused_td(*map(ref.jnp.asarray, ins), gamma=gamma, block_b=32)
    before = fused_td.launches
    loss, dq = fused_td(*_t(*ins), gamma)
    assert fused_td.launches == before
    # atol 1e-6: XLA may contract the target's multiply-add into an FMA
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=1e-6, rtol=0)


def test_fused_td_ragged_batch(ref, rng):
    """B = 200 is no multiple of a block: the reference kernel refuses it,
    the port's masks its tail.  Held against the reference oracle."""
    ins = _td_inputs(rng, 200, 6)
    l_ref, dq_ref = ref.fused_td_ref(*map(ref.jnp.asarray, ins), gamma=0.9)
    loss, dq = fused_td(*_t(*ins), 0.9)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=1e-6, rtol=0)


def test_td_loss_gradient_matches_reference(ref, rng):
    """The autograd.Function's ``grad * dq`` under a mean over B equals
    ``jax.grad`` through the reference's custom_vjp (``g * dq / B``)."""
    q_sel, q_next, r, d = _td_inputs(rng, 64, 6)
    g_ref = ref.jax.grad(lambda q: ref.td_loss(q, q_next, r, d, 0.9, True))(
        ref.jnp.asarray(q_sel)
    )
    q = torch.from_numpy(q_sel).requires_grad_(True)
    loss = td_loss(q, *_t(q_next, r, d), 0.9).mean()
    loss.backward()
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(g_ref), atol=1e-6, rtol=0)
    ref_loss = ref.td_loss(*map(ref.jnp.asarray, (q_sel, q_next, r, d)), 0.9, True)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6, rtol=0)


def test_fused_td_rejects_bad_operands(rng):
    q_sel, q_next, r, d = _t(*_td_inputs(rng, 8, 6))
    with pytest.raises(ValueError):
        fused_td(q_sel[:4], q_next, r, d, 0.9)
    with pytest.raises(TypeError):
        fused_td(q_sel.double(), q_next, r, d, 0.9)


def test_build_dir_follows_how_the_package_runs(monkeypatch, tmp_path):
    from repro_torch.kernels import lib

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    # from the checkout's src/ tree: the checkout's git-ignored build/
    monkeypatch.setattr(lib, "__file__", "/co/src/repro_torch/kernels/lib.py")
    assert lib._build_dir() == Path("/co/build/repro_torch")
    # installed: a per-user cache, never a directory beside site-packages
    monkeypatch.setattr(
        lib, "__file__", "/pfx/lib/python3.12/site-packages/repro_torch/kernels/lib.py"
    )
    assert lib._build_dir() == tmp_path / "cache" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert lib._build_dir() == tmp_path / "mine"


def test_library_hash_covers_the_shared_header(monkeypatch, tmp_path):
    """The sources include ``launch.cuh``: editing it must give another
    library file, so that a stale build is never reused."""
    for name in lib.SOURCES + lib.HEADERS:
        (tmp_path / name).write_bytes((lib.CSRC / name).read_bytes())
    monkeypatch.setattr(lib, "CSRC", tmp_path)
    before = lib.library_path()
    with (tmp_path / lib.HEADERS[0]).open("a") as f:
        f.write("// edited\n")
    assert lib.library_path() != before


def test_packed_argument_layouts():
    """The lean entry points' argument structs, packed by each kernel
    module's ``launch_args``: pointers and the stream first, then 32-bit
    fields, as in the C sources (``lib.load`` checks each size against
    the C ``sizeof`` on the card)."""
    assert lib.REPLAY_GATHER_ARGS.size == 5 * 8 + 3 * 4 + 4
    assert lib.RMSNORM_ARGS.size == 4 * 8 + 8 * 4
    raw = gather_module.launch_args(1, 2, 3, 4, 5, 6, 7, 8)
    assert struct.unpack_from("<5Q3i", raw) == (1, 2, 3, 4, 5, 6, 7, 8)
    raw = rmsnorm.launch_args(1, 2, 3, 4, 5, 6, 7, ("masked", 32, 8, True), 0.5)
    assert struct.unpack("<4Q7if", raw) == (1, 2, 3, 4, 5, 6, 7, 1, 32, 8, 1, 0.5)


@pytest.mark.parametrize("name", sorted(launch_cost.FORCED_PLANS))
def test_launch_cost_forces_plans_through_the_wrappers_packing(name):
    """The launch-cost script forces rmsnorm's plans through the packing
    the wrapper uses: each plan packs to its route's code and its launch
    shape, and the zoo's prefill and decode rows take two of them."""
    plan = launch_cost.FORCED_PLANS[name]
    way, threads, rows, vec = plan
    raw = rmsnorm.launch_args(16, 32, 48, 0, 0, 4000, 3840, plan, 1e-5)
    fields = struct.unpack("<4Q7if", raw)
    assert fields[:7] == (16, 32, 48, 0, 0, 4000, 3840)
    assert fields[7:11] == (rmsnorm.ROUTES.index(way), threads, rows, int(vec))
    for n in (4, 4000):
        assert rmsnorm.launch_plan(n, 3840, 2) in launch_cost.FORCED_PLANS.values()


# -- on the card ----------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cap,feat,batch", [(16384, 1033, 128), (128, 33, 5)])
def test_replay_gather_kernel_matches_plain_on_card(cuda, rng, cap, feat, batch):
    buf, idx, w = _t(*_gather_inputs(rng, cap, feat, batch), device=cuda)
    before = replay_gather.launches
    got = replay_gather(buf, idx, w)
    torch.cuda.synchronize()
    assert replay_gather.launches == before + 1
    assert torch.equal(got, replay_gather_plain(buf, idx, w))


@pytest.mark.cuda
@pytest.mark.parametrize("b,a", [(128, 6), (200, 6), (33, 1)])
def test_fused_td_kernel_matches_plain_on_card(cuda, rng, b, a):
    ins = _t(*_td_inputs(rng, b, a), device=cuda)
    before = fused_td.launches
    loss, dq = fused_td(*ins, 0.9)
    torch.cuda.synchronize()
    assert fused_td.launches == before + 1
    l_ref, dq_ref = fused_td_plain(*ins, 0.9)
    torch.testing.assert_close(loss, l_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dq, dq_ref, atol=1e-6, rtol=1e-6)


def _phase_cases(feat: int) -> tuple[int, np.ndarray]:
    """A pool of ``feat``-wide rows and 64 indices such that output rows
    ``i`` with each ``i % 4`` read source rows of each ``idx % 4``.  For
    widths of 1 mod 4 (33, and the fleet's 1033) those are the rows'
    phases in a 16-byte vector, so every (destination, source) pair of
    phases occurs, 4 times over."""
    cap = 256
    i = np.arange(64)
    idx = 4 * (i // 4 + 3 * (i % 7)) + (i // 16 + i) % 4
    assert {(a % 4, b % 4) for a, b in zip(i, idx)} == {
        (a, b) for a in range(4) for b in range(4)
    }
    return cap, idx.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [33, 1033, 16, 130, 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_replay_gather_every_phase_exact_on_card(cuda, rng, feat, offset):
    """Exact in every pairing of source and destination phase; ``offset``
    shifts the pool's base 4 bytes off a 16-byte boundary (a contiguous
    view), which the kernel reads from the pointer."""
    cap, idx = _phase_cases(feat)
    flat = torch.tensor(
        rng.standard_normal(cap * feat + offset), dtype=torch.float32, device=cuda
    )
    buf = flat[offset:].view(cap, feat)
    assert buf.is_contiguous() and (buf.data_ptr() % 16 == 0) == (offset == 0)
    w = torch.tensor(rng.random(len(idx)), dtype=torch.float32, device=cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    before = replay_gather.launches
    got = replay_gather(buf, idx_t, w)
    torch.cuda.synchronize()
    assert replay_gather.launches == before + 1
    assert torch.equal(got, replay_gather_plain(buf, idx_t, w))


@pytest.mark.cuda
def test_raw_stream_handle_is_the_current_stream(cuda):
    """The lean path's raw handle names the same stream as
    ``torch.cuda.current_stream(dev).cuda_stream``: on the default stream,
    on a side stream and on a graph's capture stream."""
    lib.load()
    index = cuda.index if cuda.index is not None else torch.cuda.current_device()

    def both():
        return lib.raw_stream(index), torch.cuda.current_stream(cuda).cuda_stream

    seen = [both()]
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        seen.append(both())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        seen.append(both())
    assert all(raw == want for raw, want in seen)
    assert seen[1][1] == side.cuda_stream
    assert len({want for _, want in seen}) == 3


@pytest.mark.cuda
def test_replay_gather_side_stream_and_graph_replay_on_card(cuda, rng):
    """Launched on a side stream, and captured in a CUDA graph whose
    replay (after the inputs change in place) equals an eager call."""
    buf, idx, w = _t(*_gather_inputs(rng, 4096, 1033, 128), device=cuda)
    want = replay_gather_plain(buf, idx, w)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = replay_gather(buf, idx, w)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = replay_gather(buf, idx, w)
    nb, ni, nw = _t(*_gather_inputs(rng, 4096, 1033, 128), device=cuda)
    buf.copy_(nb)
    idx.copy_(ni)
    w.copy_(nw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, replay_gather(buf, idx, w))
    assert torch.equal(captured, replay_gather_plain(buf, idx, w))
