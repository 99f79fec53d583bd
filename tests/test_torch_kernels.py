"""The port's fleet kernel modules against the reference's kernels.

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

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core.erb import (  # noqa: E402
    TaskTag,
    erb_add,
    erb_flatten,
    erb_init,
    flat_columns,
)
from repro_torch.kernels import flash_attention as attention_module  # noqa: E402
from repro_torch.kernels import fused_td as td_module  # noqa: E402
from repro_torch.kernels import kda_chunk as chunk_module  # noqa: E402
from repro_torch.kernels import kda_step as kda_module  # noqa: E402
from repro_torch.kernels import launch_cost, lib, rmsnorm  # noqa: E402
from repro_torch.kernels import mhc as mhc_module  # noqa: E402
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


# a small flat-row layout (box 2^3: F = 25) with the real column order
TD_COLUMNS = flat_columns((2, 2, 2))
TD_COLS = tuple(TD_COLUMNS[k].start for k in ("action", "reward", "done"))
TD_WIDTH = TD_COLUMNS["done"].stop


def _pack_rows(rng, action, r, d):
    """[N, B, F] rows of noise with ``action``, ``r``, ``d`` ([N, B]) in
    their columns."""
    rows = rng.standard_normal((*action.shape, TD_WIDTH)).astype(np.float32)
    for col, v in zip(TD_COLS, (action, r, d), strict=True):
        rows[..., col] = v
    return rows


def _per_row_as_tail(rng, q_sel, q_next, r, d):
    """The per-row kernel's inputs as the fused tail's, for one agent:
    q_sel placed at a drawn action of a [1, B, A] q, r and d packed into
    rows.  Returns (q, q_next, rows, action [B])."""
    b, a = q_next.shape
    action = rng.integers(0, a, b)
    q = rng.standard_normal((1, b, a)).astype(np.float32)
    q[0, np.arange(b), action] = q_sel[:, 0]
    rows = _pack_rows(
        rng, action[None].astype(np.float32), r[:, 0][None], d[:, 0][None]
    )
    return q, q_next[None], rows, action


def _tail_inputs(rng, n, b, a):
    """q, q_next [N, B, A] and rows [N, B, F] with in-range actions."""
    q = rng.standard_normal((n, b, a)).astype(np.float32)
    q_next = rng.standard_normal((n, b, a)).astype(np.float32)
    action = rng.integers(0, a, (n, b)).astype(np.float32)
    r = rng.standard_normal((n, b)).astype(np.float32)
    d = (rng.random((n, b)) < 0.3).astype(np.float32)
    return q, q_next, _pack_rows(rng, action, r, d)


def _jax_tail(ref, q, q_next, rows, cols, gamma):
    """The reference's TD tail per agent (``make_dqn_loss_fn``'s
    ``take_along_axis`` then ``td_loss`` with the Pallas kernel in
    interpret mode), vmapped over agents: (loss [N], d loss.sum() / d q)."""
    jnp = ref.jnp
    col_a, col_r, col_d = cols
    action = jnp.asarray(rows[..., col_a]).astype(jnp.int32)
    r, d = jnp.asarray(rows[..., col_r]), jnp.asarray(rows[..., col_d])

    def agent(q, q_next, a, r, d):
        q_sel = jnp.take_along_axis(q, a[:, None], 1)
        return ref.td_loss(q_sel, q_next, r[:, None], d[:, None], gamma, True)

    def total(q):
        return ref.jax.vmap(agent)(q, jnp.asarray(q_next), action, r, d)

    loss = total(jnp.asarray(q))
    grad = ref.jax.grad(lambda q: total(q).sum())(jnp.asarray(q))
    return np.asarray(loss), np.asarray(grad)


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


def other_device(*shape):
    """What ``lib.device_index`` reads of a tensor on a device that is
    neither the CPU, ``meta`` nor CUDA (none exists in a CPU build)."""
    return SimpleNamespace(is_cuda=False, device=torch.device("xpu"), shape=shape)


def test_replay_gather_never_falls_back_off_the_cpu(rng):
    """Operands on two devices are refused; ``meta`` operands (the
    planner's shapes, no data) take the plain version like the CPU's; a
    device that is neither the CPU, ``meta`` nor CUDA raises instead of
    taking the plain version."""
    buf, idx, w = _t(*_gather_inputs(rng, 16, 8, 4))
    with pytest.raises(ValueError, match="different devices"):
        replay_gather(buf.to("meta"), idx, w)
    with pytest.raises(ValueError, match="different devices"):
        replay_gather(buf, idx, w.to("meta"))
    before = replay_gather.launches
    out = replay_gather(*(t.to("meta") for t in (buf, idx, w)))
    assert out.device.type == "meta" and out.shape == (4, 8)
    assert replay_gather.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        lib.device_index("replay_gather", other_device(16, 8), other_device(4))


# the shapes of tests/test_kernels.py, block_b = 32 as there
@pytest.mark.parametrize("b,a,gamma", [(64, 6, 0.9), (128, 4, 0.99), (32, 6, 0.5)])
def test_fused_td_matches_reference_kernel(ref, rng, b, a, gamma):
    """The fused tail's per-row outputs against the reference's per-row
    kernel, its q_sel placed at a drawn action of q."""
    ins = _td_inputs(rng, b, a)
    l_ref, dq_ref = ref.fused_td(*map(ref.jnp.asarray, ins), gamma=gamma, block_b=32)
    q, q_next, rows, _ = _per_row_as_tail(rng, *ins)
    before = fused_td.launches
    out = fused_td(*_t(q, q_next, rows), TD_COLS, gamma)
    assert fused_td.launches == before
    # atol 1e-6: XLA may contract the target's multiply-add into an FMA
    np.testing.assert_allclose(out.loss_rows[0].numpy(), l_ref[:, 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.dq[0].numpy(), dq_ref[:, 0], atol=1e-6, rtol=0)


def test_fused_td_ragged_batch(ref, rng):
    """B = 200 is no multiple of a block: the reference kernel refuses it,
    the port's masks its tail.  Held against the reference oracle."""
    ins = _td_inputs(rng, 200, 6)
    l_ref, dq_ref = ref.fused_td_ref(*map(ref.jnp.asarray, ins), gamma=0.9)
    q, q_next, rows, _ = _per_row_as_tail(rng, *ins)
    out = fused_td(*_t(q, q_next, rows), TD_COLS, 0.9)
    np.testing.assert_allclose(out.loss_rows[0].numpy(), l_ref[:, 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.dq[0].numpy(), dq_ref[:, 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        out.loss.numpy(), [float(np.mean(l_ref))], atol=1e-6, rtol=0
    )


def test_td_loss_gradient_matches_reference(ref, rng):
    """The autograd.Function's ``grad * grad_q`` equals ``jax.grad``
    through the reference's custom_vjp (``g * dq / B``) at the selected
    action, and 0 at every other."""
    q_sel, q_next, r, d = _td_inputs(rng, 64, 6)
    g_ref = ref.jax.grad(lambda q: ref.td_loss(q, q_next, r, d, 0.9, True))(
        ref.jnp.asarray(q_sel)
    )
    q_np, qn, rows, action = _per_row_as_tail(rng, q_sel, q_next, r, d)
    q = torch.from_numpy(q_np).requires_grad_(True)
    loss = td_loss(q, *_t(qn, rows), TD_COLS, 0.9)
    assert loss.shape == (1,)
    loss.sum().backward()
    want = np.zeros_like(q_np)
    want[0, np.arange(64), action] = np.asarray(g_ref)[:, 0]
    np.testing.assert_allclose(q.grad.numpy(), want, atol=1e-6, rtol=0)
    ref_loss = ref.td_loss(*map(ref.jnp.asarray, (q_sel, q_next, r, d)), 0.9, True)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6, rtol=0)


def test_launch_cost_times_fused_td_on_the_fleet_layout():
    """The launch-cost script times fused_td on the operands the fleet's
    step passes: its row width, its action/reward/done columns, its gamma,
    in-range actions; the wrapper takes them (here: its plain version)."""
    from repro_torch.rl.fleet import FleetSteps

    cfg = DQNConfig()
    steps = FleetSteps(cfg, "cpu")
    q, q_next, rows, cols, gamma = launch_cost.fused_td_operands("cpu")
    assert q.shape == q_next.shape == (4, cfg.batch_size, cfg.n_actions)
    assert rows.shape == (4, cfg.batch_size, steps.feat)
    assert cols == steps.td_cols and gamma == cfg.gamma
    action = rows[..., cols[0]]
    assert bool(((action >= 0) & (action < cfg.n_actions)).all())
    out = fused_td(q, q_next, rows, cols, gamma)
    assert bool(torch.isfinite(out.loss).all()) and out.grad_q.shape == q.shape


def test_fused_td_rejects_bad_operands(rng):
    q, q_next, rows = _t(*_tail_inputs(rng, 2, 8, 6))
    with pytest.raises(ValueError):
        fused_td(q[:, :4], q_next, rows, TD_COLS, 0.9)
    with pytest.raises(TypeError):
        fused_td(q.double(), q_next, rows, TD_COLS, 0.9)
    with pytest.raises(ValueError):
        fused_td(q, q_next, rows, (0, 1, TD_WIDTH), 0.9)  # past the row
    with pytest.raises(ValueError):
        strided = q.transpose(0, 1).contiguous().transpose(0, 1)
        fused_td(strided, q_next, rows, TD_COLS, 0.9)
    with pytest.raises(ValueError, match="different devices"):
        fused_td(q, q_next, rows.to("meta"), TD_COLS, 0.9)
    before = fused_td.launches
    out = fused_td(q.to("meta"), q_next.to("meta"), rows.to("meta"), TD_COLS, 0.9)
    assert out.grad_q.device.type == "meta" and out.grad_q.shape == q.shape
    assert fused_td.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        lib.device_index("fused_td", other_device(*q.shape), other_device(*q.shape))


# (N, B, A): the fleet's step, a ragged batch, one agent with one action
TAIL_SHAPES = [(4, 32, 6), (3, 50, 6), (1, 7, 1)]


@pytest.mark.parametrize("n,b,a", TAIL_SHAPES)
def test_td_tail_matches_reference(ref, rng, n, b, a):
    """The whole tail (select, TD target, Huber, per-agent mean, gradient)
    against the reference's ``take_along_axis`` + ``td_loss`` vmapped over
    agents: per-agent loss and d loss / d q within 1e-6; per-row loss and
    dq within 1e-6 of the reference's Pallas kernel.  At B = 32 each
    side's gradient is exactly its own dq / 32 at the selected action:
    the mean's backward adds no rounding (XLA may contract the target's
    multiply-add into an FMA, which moves dq itself by an ulp, inside the
    1e-6)."""
    q_np, qn_np, rows_np = _tail_inputs(rng, n, b, a)
    want_loss, want_grad = _jax_tail(ref, q_np, qn_np, rows_np, TD_COLS, 0.9)
    q = torch.from_numpy(q_np).requires_grad_(True)
    qn, rows = _t(qn_np, rows_np)
    loss = td_loss(q, qn, rows, TD_COLS, 0.9)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-6, rtol=0)
    np.testing.assert_allclose(q.grad.numpy(), want_grad, atol=1e-6, rtol=0)
    out = fused_td(q.detach(), qn, rows, TD_COLS, 0.9)
    assert torch.equal(out.grad_q, q.grad)  # backward: grad (ones) * grad_q
    # the per-row kernel on all N * B rows at once (block_b = B divides them)
    action = rows_np[..., TD_COLS[0]].astype(np.int32)
    sel = np.take_along_axis(q_np, action[..., None], 2)
    per_row = [
        sel.reshape(-1, 1),
        qn_np.reshape(-1, a),
        rows_np[..., TD_COLS[1]].reshape(-1, 1),
        rows_np[..., TD_COLS[2]].reshape(-1, 1),
    ]
    l_ref, dq_ref = ref.fused_td(*map(ref.jnp.asarray, per_row), gamma=0.9, block_b=b)
    l_ref, dq_ref = np.asarray(l_ref).reshape(n, b), np.asarray(dq_ref).reshape(n, b)
    np.testing.assert_allclose(out.loss_rows.numpy(), l_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.dq.numpy(), dq_ref, atol=1e-6, rtol=0)
    if b == 32:
        picked = np.arange(a) == action[..., None]
        for grad, dq in ((q.grad.numpy(), out.dq.numpy()), (want_grad, dq_ref)):
            assert np.array_equal(grad, np.where(picked, dq[..., None] / 32, 0))


def _out_of_range_inputs(rng):
    """Two agents of B = 8, A = 6, whose stored actions run through the
    edges of the float -> int -> index decode: truncation (2.7, -0.5), a
    NaN action (0, as astype), [-A, -1] (wraps), A and beyond, below -A."""
    q, q_next, rows = _tail_inputs(rng, 2, 8, 6)
    rows[0, :, TD_COLS[0]] = [2.7, -0.5, np.nan, -1, -6, 5, 5.9, 0]
    rows[1, :, TD_COLS[0]] = [6, 7, -7, -100, 1e10, 3, 1, 2]
    return q, q_next, rows


def test_td_tail_out_of_range_actions_follow_jax(ref, rng):
    """An index of A or more, or below -A, selects NaN as JAX's
    ``take_along_axis`` does (``torch.gather`` would raise), and its row
    gets no gradient; -1 .. -A wrap; a NaN action reads as 0."""
    q_np, qn_np, rows_np = _out_of_range_inputs(rng)
    want_loss, want_grad = _jax_tail(ref, q_np, qn_np, rows_np, TD_COLS, 0.9)
    q = torch.from_numpy(q_np).requires_grad_(True)
    qn, rows = _t(qn_np, rows_np)
    loss = td_loss(q, qn, rows, TD_COLS, 0.9)
    loss.sum().backward()
    assert np.isfinite(want_loss[0]) and np.isnan(want_loss[1])
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-6, rtol=0)
    np.testing.assert_allclose(q.grad.numpy(), want_grad, atol=1e-6, rtol=0)
    out = fused_td(q.detach(), qn, rows, TD_COLS, 0.9)
    assert torch.isnan(out.loss_rows[1, :5]).all()
    assert torch.isfinite(out.loss_rows[1, 5:]).all()
    assert torch.isfinite(out.loss_rows[0]).all()
    assert not out.grad_q[1, :5].any()
    # -1 selects the last action, -6 the first, NaN the first
    assert out.grad_q[0, 3, 5] != 0 and out.grad_q[0, 4, 0] != 0
    assert out.grad_q[0, 2, 0] != 0


def test_td_tail_on_erb_flatten_rows(ref, rng):
    """Rows in the port's ``erb_flatten`` layout at ``DQNConfig()``'s box,
    read at the fleet's own column offsets (515, 516, 1032), against the
    reference tail fed the ERB's fields directly."""
    cfg = DQNConfig()
    steps_cols = flat_columns(cfg.box_size)
    cols = tuple(steps_cols[k].start for k in ("action", "reward", "done"))
    assert cols == (515, 516, 1032)
    n, b, a = 2, 32, cfg.n_actions
    erb = erb_init(n * b, cfg.box_size, task=TaskTag("t1", "axial", "HGG"))
    fields = {
        "obs": rng.standard_normal((n * b, *cfg.box_size)).astype(np.float32),
        "loc": rng.random((n * b, 3)).astype(np.float32),
        "action": rng.integers(0, a, n * b).astype(np.int32),
        "reward": rng.standard_normal(n * b).astype(np.float32),
        "next_obs": rng.standard_normal((n * b, *cfg.box_size)).astype(np.float32),
        "next_loc": rng.random((n * b, 3)).astype(np.float32),
        "done": (rng.random(n * b) < 0.3).astype(np.float32),
    }
    erb_add(erb, fields)
    rows_np = erb_flatten(erb).reshape(n, b, -1)
    q_np = rng.standard_normal((n, b, a)).astype(np.float32)
    qn_np = rng.standard_normal((n, b, a)).astype(np.float32)
    direct = _pack_rows(
        rng,
        fields["action"].reshape(n, b).astype(np.float32),
        fields["reward"].reshape(n, b),
        fields["done"].reshape(n, b),
    )
    want_loss, want_grad = _jax_tail(ref, q_np, qn_np, direct, TD_COLS, 0.99)
    q = torch.from_numpy(q_np).requires_grad_(True)
    loss = td_loss(q, *_t(qn_np, rows_np), cols, 0.99)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-6, rtol=0)
    np.testing.assert_allclose(q.grad.numpy(), want_grad, atol=1e-6, rtol=0)


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
    assert lib.FUSED_TD_ARGS.size == 10 * 8 + 8 * 4 + 4 + 4
    raw = td_module.launch_args(*range(1, 16), 515, 516, 1032, 0.5)
    assert struct.unpack("<10Q8if4x", raw) == (*range(1, 16), 515, 516, 1032, 0.5)
    assert lib.FLASH_ATTENTION_ARGS.size == 5 * 8 + 8 * 4 + 2 * 4
    raw = attention_module.launch_args(*range(1, 12), 1, 0, 0.25, 2.0)
    assert struct.unpack("<5Q8i2f", raw) == (*range(1, 12), 1, 0, 0.25, 2.0)
    assert lib.KDA_STEP_ARGS.size == 6 * 8 + 4 * 4 + 2 * 4
    raw = kda_module.launch_args(*range(1, 11), 0.25)
    fields = struct.unpack("<6Q4i2f", raw)
    assert fields[:11] == (*range(1, 11), 0.25)
    assert fields[11] == pytest.approx(kda_module.L2_EPS)  # float32 in the struct
    # one calling convention: every entry point takes one packed struct
    assert {fmt for _, fmt in lib.ENTRY_POINTS.values()} == {
        lib.REPLAY_GATHER_ARGS,
        lib.FUSED_TD_ARGS,
        lib.RMSNORM_ARGS,
        lib.FLASH_ATTENTION_ARGS,
        lib.KDA_STEP_ARGS,
        lib.KDA_CHUNK_ARGS,
        lib.MHC_PRE_ARGS,
        lib.MHC_POST_ARGS,
    }


def test_mhc_packed_arguments():
    """G's ``MhcPreArgs``: eleven pointers (the stream last), seven 32-bit
    ints (device, t, c, n and the plan's rows a warp, slices and tiles a
    slice), then the norm's eps as float32 (the Sinkhorn's alternations,
    eps and clamp are the kernel's constants); ``MhcPostArgs``: six
    pointers and four ints."""
    assert lib.MHC_PRE_ARGS.size == 11 * 8 + 7 * 4 + 4
    raw = mhc_module.pre_launch_args(*range(1, 16), (1, 14, 4), 1e-6)
    fields = struct.unpack("<11Q7if", raw)
    assert fields[:18] == (*range(1, 16), 1, 14, 4)
    assert fields[18] == pytest.approx(1e-6)
    assert lib.MHC_POST_ARGS.size == 6 * 8 + 4 * 4
    raw = mhc_module.post_launch_args(*range(1, 11))
    assert struct.unpack("<6Q4i", raw) == tuple(range(1, 11))


@pytest.mark.parametrize(
    "t,k,want",
    [(128, 14336, (1, 14, 4)), (4, 1024, (1, 4, 1)), (4096, 14336, (1, 1, 56)),
     (131072, 14336, (4, 1, 56)), (8192, 1024, (4, 1, 4))],
)  # fmt: skip
def test_mhc_pre_plan(t, k, want):
    """G's plan: a decode's 128 rows spread over 14 slices of 4 tiles
    (16 row blocks x 14 = 224 CTAs, about two an SM), a prefill's rows in
    one slice, 32 rows a CTA from 8,192 rows on."""
    assert mhc_module.pre_plan(t, k) == want


def test_kda_chunk_packed_arguments():
    """F's ``KdaChunkArgs``: six pointers (the stream last), five 32-bit
    ints (device, b, s, h, d), scale and the L2 norms' eps, then the C
    struct's padding to a multiple of 8 bytes."""
    assert lib.KDA_CHUNK_ARGS.size == 6 * 8 + 5 * 4 + 2 * 4 + 4
    raw = chunk_module.launch_args(*range(1, 12), 0.25)
    fields = struct.unpack("<6Q5i2f4x", raw)
    assert fields[:12] == (*range(1, 12), 0.25)
    assert fields[12] == pytest.approx(chunk_module.L2_EPS)  # float32 in the struct


# a case of (qkv, g, beta, o's dtype) changed from a good call: B 2, S 9,
# H 2, d 32, all float32; and the error it raises
KDA_CHUNK_REFUSED = {
    "qkv_4d": ({"qkv": torch.zeros(2, 9, 3, 64)}, ValueError),
    "qkv_not_3": ({"qkv": torch.zeros(2, 9, 2, 2, 32)}, ValueError),
    "g_shape": ({"g": torch.zeros(2, 9, 2, 16)}, ValueError),
    "beta_shape": ({"beta": torch.zeros(2, 9)}, ValueError),
    "qkv_bf16": ({"qkv": torch.zeros(2, 9, 3, 2, 32, dtype=torch.bfloat16)}, TypeError),
    "g_f64": ({"g": torch.zeros(2, 9, 2, 32, dtype=torch.float64)}, TypeError),
    "o_f16": ({"dtype": torch.float16}, TypeError),
}


@pytest.mark.parametrize("case", sorted(KDA_CHUNK_REFUSED))
def test_kda_chunk_refuses_what_no_route_takes(case):
    """A shape or dtype the recurrence does not take raises on every route,
    the CPU's included, before anything runs or is counted."""
    changed, err = KDA_CHUNK_REFUSED[case]
    call = {
        "qkv": torch.zeros(2, 9, 3, 2, 32),
        "g": torch.zeros(2, 9, 2, 32),
        "beta": torch.zeros(2, 9, 2),
        "dtype": torch.float32,
        **changed,
    }
    routes = dict(chunk_module.kda_chunk.calls_by_route)
    with pytest.raises(err):
        chunk_module.kda_chunk(
            call["qkv"], call["g"], call["beta"], 0.25, 64, call["dtype"]
        )
    assert chunk_module.kda_chunk.calls_by_route == routes


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


def _assert_tail_equal(got, want):
    """Every output within 1e-6 (NaN where the plain version has NaN); the
    statistics where both sides carry them (the plain version always
    does, the kernel only when asked)."""
    for name, x, y in zip(got._fields, got, want, strict=True):
        if name in ("td_abs", "q_max") and (x is None or y is None):
            continue
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6, equal_nan=True, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,a", TAIL_SHAPES)
def test_fused_td_kernel_matches_plain_on_card(cuda, rng, n, b, a):
    ins = _t(*_tail_inputs(rng, n, b, a), device=cuda)
    before = fused_td.launches
    out = fused_td(*ins, TD_COLS, 0.9)
    torch.cuda.synchronize()
    assert fused_td.launches == before + 1
    _assert_tail_equal(out, fused_td_plain(*ins, TD_COLS, 0.9))


@pytest.mark.cuda
def test_fused_td_out_of_range_actions_on_card(cuda, rng):
    ins = _t(*_out_of_range_inputs(rng), device=cuda)
    out = fused_td(*ins, TD_COLS, 0.9)
    torch.cuda.synchronize()
    _assert_tail_equal(out, fused_td_plain(*ins, TD_COLS, 0.9))
    assert torch.isnan(out.loss[1]) and torch.isfinite(out.loss[0])


@pytest.mark.cuda
def test_td_loss_backward_through_the_dqn_on_card(cuda, rng):
    """The gradient reaches the DQN's params through the real stacked
    forward (q out of a bmm), equal to autograd through the plain tail,
    at the fleet's row layout (F = 1033, columns 515, 516, 1032)."""
    from repro_torch.rl.dqn import dqn_apply_stacked, dqn_init
    from repro_torch.rl.fleet import FleetSteps

    cfg = DQNConfig()
    steps = FleetSteps(cfg, cuda)
    n, b = 4, cfg.batch_size
    gen = torch.Generator().manual_seed(0)
    params = [dqn_init(cfg, gen, cuda) for _ in range(n)]
    params = {
        k: {
            m: torch.stack([p[k][m] for p in params]).requires_grad_(True)
            for m in params[0][k]
        }
        for k in params[0]
    }
    rows_np = rng.standard_normal((n, b, steps.feat))
    rows_np[..., steps.td_cols[0]] = rng.integers(0, cfg.n_actions, (n, b))
    obs, loc, q_next, rows = _t(
        rng.random((n, b, *cfg.box_size)).astype(np.float32),
        rng.random((n, b, 3)).astype(np.float32),
        rng.standard_normal((n, b, cfg.n_actions)).astype(np.float32),
        rows_np.astype(np.float32),
        device=cuda,
    )
    leaves = [t for d in params.values() for t in d.values()]
    grads = []
    for tail in (
        lambda q: td_loss(q, q_next, rows, steps.td_cols, cfg.gamma),
        lambda q: fused_td_plain(q, q_next, rows, steps.td_cols, cfg.gamma).loss,
    ):
        q = dqn_apply_stacked(cfg, params, obs, loc)
        grads.append(torch.autograd.grad(tail(q).sum(), leaves))
    torch.cuda.synchronize()
    for g, p in zip(*grads, strict=True):
        torch.testing.assert_close(g, p, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_fused_td_side_stream_and_graph_replay_on_card(cuda, rng):
    """Launched on a side stream, and captured in a CUDA graph (the
    wrapper allocates its outputs and nothing else) whose replay, after
    the inputs change in place, equals an eager call."""
    ins = _t(*_tail_inputs(rng, 4, 32, 6), device=cuda)
    want = fused_td_plain(*ins, TD_COLS, 0.9)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = fused_td(*ins, TD_COLS, 0.9)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    _assert_tail_equal(got, want)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_td(*ins, TD_COLS, 0.9)
    for t, new in zip(ins, _t(*_tail_inputs(rng, 4, 32, 6), device=cuda), strict=True):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    _assert_tail_equal(captured, fused_td(*ins, TD_COLS, 0.9))
    _assert_tail_equal(captured, fused_td_plain(*ins, TD_COLS, 0.9))


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
