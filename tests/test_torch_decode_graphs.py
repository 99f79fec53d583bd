"""The zoo's decode graphs as far as the CPU sees them, and the
benchmark's reader of them.

* The graph path's cache length: the conversation's length rounded up
  to a multiple of 64 slots.
* Where the path applies: a CUDA device, no mesh and no
  ``named_ranges()`` open; elsewhere ``generate`` decodes eagerly into
  fresh caches of ``S + gen`` slots, and the route count says so.
* The decode arena's caches, filled on the CPU (no graph is captured
  there): the prefill loaded in place, equal to fresh caches loaded the
  eager way; a longer prompt then a shorter one in one bucket leaves no
  stale slot; leaves whose shape does not depend on the cache length
  are one tensor across the buckets of a batch.
* ``perfbench/metrics/graph_share.decode.py``: the replayed share of the
  counted steps, nothing from a program without the count.

The card's side (graphs against the eager loop, bit for bit) is
``tests/test_torch_cuda_paths.py -m cuda -k decode_graph``.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.layers import named_ranges  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    graph_cache_len,
    graphs_apply,
    make_serve_step,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import bench  # noqa: E402

DECODE_CELLS = ("deepseek-v2-lite-16b.decode", "kimi-linear-48b-a3b.decode_b128")


@pytest.mark.parametrize(
    "seq_len,want",
    [(1, 64), (63, 64), (64, 64), (65, 128), (256 + 2, 320), (256 + 64, 320),
     (1000 + 32, 1088), (1024 + 64, 1088), (2048 + 64, 2112)],
)  # fmt: skip
def test_graph_cache_len_rounds_up_to_64_slots(seq_len, want):
    assert graph_cache_len(seq_len) == want


def test_graph_path_needs_a_card_no_mesh_and_no_named_ranges():
    card = SimpleNamespace(device=torch.device("cuda"), mesh=None)
    assert graphs_apply(card)
    assert not graphs_apply(SimpleNamespace(device=torch.device("cpu"), mesh=None))
    assert not graphs_apply(SimpleNamespace(device=torch.device("cuda"), mesh=object()))
    with named_ranges():
        assert not graphs_apply(card)
    assert graphs_apply(card)


@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b-smoke", "kimi-linear-48b-a3b-ep4-smoke"]
)
def test_cpu_generate_decodes_eagerly_into_fresh_caches(arch):
    model = Model(get_config(arch), "cpu")
    params = model.init_params(0)
    prompt = torch.tensor(serve.prompt_tokens(model.cfg.vocab_size, 2, 21, 0))
    lengths = []
    serve_step = model.serve_step

    def watched(params, caches, batch):
        lengths.append({t.shape[-1] for t in _kpos(caches)})
        return serve_step(params, caches, batch)

    model.serve_step = watched
    before = dict(make_serve_step.steps_by_route)
    out = serve.generate(model, params, prompt, 4)
    after = make_serve_step.steps_by_route
    assert set(after) == {"eager", "capture", "replay"}
    assert after["eager"] - before["eager"] == 4
    assert (after["capture"], after["replay"]) == (before["capture"], before["replay"])
    assert lengths == [{21 + 4}] * 4  # S + gen, not the 64-slot bucket
    assert out.tokens.shape == (2, 5) and model.arena.graphs == {}


def _kpos(tree) -> list:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in ([v] if k == "kpos" else _kpos(v))]
    return []


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _prefill(model, params, s, seed):
    prompt = torch.tensor(serve.prompt_tokens(model.cfg.vocab_size, 2, s, seed))
    return model.prefill_step(params, {"tokens": prompt})[1]


@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b-smoke", "kimi-linear-48b-a3b-ep4-smoke",
             "h2o-danube-3-4b-smoke", "jamba-1.5-large-398b-smoke", "xlstm-125m-smoke"],
)  # fmt: skip
def test_arena_loads_in_place_and_forgets_a_longer_prompt(arch):
    """A prompt of 50, then one of 21, into the one 64-slot bucket: the
    caches keep their tensors and equal fresh caches of 64 slots loaded
    with the second prefill alone (``kpos`` -1 and zeros past slot 21,
    the states the second prompt's)."""
    model = Model(get_config(arch), "cpu")
    params = model.init_params(0)
    first = model.arena.load(_prefill(model, params, 50, 1), 2, 50 + 5)
    ptrs = [t.data_ptr() for t in _leaves(first)]
    pre = _prefill(model, params, 21, 2)
    fresh = serve.load_prefill(model.init_caches(2, 64), _prefill(model, params, 21, 2))
    second = model.arena.load(pre, 2, 21 + 5)
    assert second is first and [t.data_ptr() for t in _leaves(second)] == ptrs
    assert model.arena.graph_of(second) is model.arena.graphs[(2, 64)]
    assert model.arena.graph_of(fresh) is None
    _equal_trees(second, fresh)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_arena_shares_the_leaves_whose_shape_ignores_the_cache_length():
    """Kimi-Linear's KDA state and convolution tail are one tensor across
    the buckets of a batch; MLA's latent cache and ``kpos`` are not; a
    second batch size has leaves of its own."""
    model = Model(get_config("kimi-linear-48b-a3b-ep4-smoke"), "cpu")
    params = model.init_params(0)
    a = model.arena.load(_prefill(model, params, 30, 3), 2, 34)
    b = model.arena.load(_prefill(model, params, 90, 4), 2, 94)
    assert sorted(model.arena.graphs) == [(2, 64), (2, 128)]
    for kda in (("prefix", "l0"), ("groups", "b0"), ("suffix", "l0")):
        for leaf in ("state", "conv"):
            assert _at(a, kda)[leaf] is _at(b, kda)[leaf]
    for mla in (("groups", "b1"), ("suffix", "l1")):
        for leaf in ("ckv", "krope", "kpos"):
            assert _at(a, mla)[leaf] is not _at(b, mla)[leaf]
    prompt = torch.tensor(serve.prompt_tokens(model.cfg.vocab_size, 3, 30, 5))
    c = model.arena.load(model.prefill_step(params, {"tokens": prompt})[1], 3, 34)
    assert c["groups"]["b0"]["state"] is not a["groups"]["b0"]["state"]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_in_place_load_refuses_a_leaf_that_does_not_fit():
    model = Model(get_config("deepseek-v2-lite-16b-smoke"), "cpu")
    params = model.init_params(0)
    long = _prefill(model, params, 70, 6)
    with pytest.raises(ValueError, match="does not fit"):
        model.arena.load(long, 2, 30)  # 64 slots for a 70-token prompt


# -- the benchmark's reader ----------------------------------------------------


def _read(monkeypatch, routes):
    if routes is None:  # the program before decode graphs: no count at all
        monkeypatch.delattr(make_serve_step, "steps_by_route")
    else:
        monkeypatch.setattr(make_serve_step, "steps_by_route", routes)
    cell = bench.load_cell(DECODE_CELLS[0])
    return cell.metric_reader("graph_share.decode").read(SimpleNamespace())


@pytest.mark.parametrize("cell", DECODE_CELLS)
def test_graph_share_decode_is_the_decode_cells_metric(cell):
    layer = bench.load_cell(cell).per_layer
    (metric,) = [m for m in layer if m.name == "graph_share.decode"]
    want = ("%", "higher", "program_span", "gen_tok_per_s")
    assert (metric.unit, metric.better, metric.source, metric.moves) == want


@pytest.mark.parametrize(
    "routes,want",
    [
        ({"eager": 0, "capture": 4, "replay": 388}, 100.0 * 388 / 392),
        ({"eager": 3, "capture": 1, "replay": 0}, 0.0),
        ({"eager": 0, "capture": 0, "replay": 0}, None),
        ({"eager": 12}, None),
        (None, None),
    ],
)
def test_graph_share_decode_reads_the_replayed_steps(monkeypatch, routes, want):
    got = _read(monkeypatch, routes)
    assert got == (pytest.approx(want) if want is not None else None)
