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

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

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
