"""Sharing planes — the data planes federated through hubs and gossip.

The paper federates exactly one artifact: experience replay buffers
(:class:`~repro_torch.core.erb.ERB`).  A :class:`SharePlane` gives a
record type its identity, admission and retention, wire encoding and
wire size, so the hub and gossip transports carry any record type:

* :class:`ERBPlane` — the paper's plane. Records are ERBs, identity is
  ``meta.erb_id``, stores keep everything (experience never goes stale).
* :class:`WeightPlane` — a parameter-level plane in the spirit of
  FedAsync: agents push :class:`WeightSnapshot` records (params +
  round/timestamp provenance) and pull peer snapshots, which they fold
  into their own parameters with a staleness-discounted mixing rate
  ``alpha_t = alpha * s(delta_tau)``.
* :class:`CompressedWeightPlane` — the same plane, wire-efficient:
  snapshots cross the network as int8-quantized trees or top-k
  int8-quantized deltas (:class:`CompressedWeightSnapshot`), and are
  dequantized on the receiving side inside :func:`mix_params`.

Parameter trees are the port's dicts of dicts of tensors; a leaf order is
:func:`~repro_torch.optim.adamw.leaves`' (the reference's pytree order).
Compression runs on the host in numpy, as the reference's does: one
device-to-host copy per encoded snapshot, and the same
``np.argpartition`` / ``np.rint`` / int8 cast, so the coordinates and
codes it picks are the reference's for the same numbers.

Staleness functions follow FedAsync's three families (``constant`` /
``hinge`` / ``poly``), clamped to (0, 1] so mixing is always a convex
combination.
"""

from __future__ import annotations

import itertools
from collections.abc import Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.erb import ERB
from repro_torch.optim.adamw import leaves

_SNAP_COUNTER = itertools.count()


def new_snap_id(prefix: str = "W") -> str:
    return f"{prefix}_{next(_SNAP_COUNTER):05d}"


@dataclass(frozen=True)
class WeightSnapshot:
    """One pushed parameter state: the unit of the weight plane.

    ``round_idx`` is the sender's local round counter when the snapshot
    was taken (the FedAsync ``tau``); ``sim_time`` is scheduler time at
    the push.  ``params`` is a parameter tree the sender no longer writes
    (:meth:`~repro_torch.rl.agent.DQNAgent.snapshot_params` copies it), so
    it is safe to share by reference.

    ``version_vector`` is BrainTorrent-style provenance the observatory
    stamps when enabled: a sorted tuple of ``(agent_id, round_idx)``
    pairs recording the sender's view of every peer's progress at push
    time.  Purely observational — the default empty tuple is never read
    by the numeric mixing path.
    """

    snap_id: str
    agent_id: int
    round_idx: int
    sim_time: float
    params: Any
    version_vector: tuple = ()

    @property
    def record_id(self) -> str:
        return self.snap_id


# ---------------------------------------------------------------------------
# quantized wire format (CompressedWeightPlane)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantizedLeaf:
    """One tree leaf on the wire: int8 codes + scale (+ top-k indices).

    Dense leaves (``idx is None``) carry a code per element; sparse
    delta leaves carry codes only for the ``idx`` coordinates.
    """

    q: np.ndarray  # int8 codes, flat
    scale: float
    shape: tuple[int, ...]
    idx: np.ndarray | None = None  # int32 flat coords (top-k deltas)

    @property
    def nbytes(self) -> int:
        n = self.q.nbytes + 4  # codes + float32 scale
        if self.idx is not None:
            n += self.idx.nbytes
        return n

    def dequantize_dense(self) -> np.ndarray:
        return (self.q.astype(np.float32) * self.scale).reshape(self.shape)


def _quantize_int8(x: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor int8: ``x ~= q * scale`` with |q| <= 127."""
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    if amax <= 0.0:
        return np.zeros(x.shape, np.int8), 0.0
    scale = amax / 127.0
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _host_leaves(params: dict) -> list[np.ndarray]:
    """A tree's leaves as float32 numpy arrays, in one device-to-host copy."""
    ls = leaves(params)
    flat = torch.cat([x.detach().reshape(-1).float() for x in ls]).cpu().numpy()
    sizes = np.cumsum([x.numel() for x in ls])[:-1]
    return [
        part.reshape(tuple(x.shape))
        for part, x in zip(np.split(flat, sizes), ls, strict=True)
    ]


def _unflatten(treedef: tuple[tuple[str, str], ...], arrs: Sequence[np.ndarray]):
    """Leaves (numpy) back into a dict-of-dicts tree of CPU tensors."""
    out: dict = {}
    for (layer, name), a in zip(treedef, arrs, strict=True):
        out.setdefault(layer, {})[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


@dataclass(frozen=True)
class CompressedWeightSnapshot:
    """Wire-format weight record: quantized leaves instead of a tree.

    ``mode`` is ``"dense"`` (int8 full snapshot, self-contained) or
    ``"delta"`` (top-k int8-quantized delta vs the sender's previous
    transmitted state).  Delta records carry the sender-side
    reconstruction (``dense_params``) so hub replication and late pulls
    need not replay the delta chain — equivalent to assuming reliable
    in-order delta delivery per sender.  The transports uphold that:
    encoding happens once at the network ingress edge *after* the
    hub-link drop decision (a dropped upload never advances the chain),
    and gossip anti-entropy retries a record from the sender's store
    until a copy lands.  ``payload_nbytes`` counts only what would cross
    the wire: codes, indices, and scales.  ``treedef`` holds the
    ``(layer, name)`` path of each leaf, in leaf order.
    """

    snap_id: str
    agent_id: int
    round_idx: int
    sim_time: float
    mode: str
    leaves: tuple[QuantizedLeaf, ...]
    treedef: tuple[tuple[str, str], ...]
    payload_nbytes: int
    dense_params: Any = None  # delta mode: sender-side reconstruction
    version_vector: tuple = ()  # observational provenance, carried verbatim

    @property
    def record_id(self) -> str:
        return self.snap_id

    def dequantize(self) -> dict:
        """Materialize the float32 tree (CPU tensors) this record represents."""
        if self.dense_params is not None:
            return self.dense_params
        return _unflatten(self.treedef, [x.dequantize_dense() for x in self.leaves])


# ---------------------------------------------------------------------------
# plane protocol
# ---------------------------------------------------------------------------
class SharePlane:
    """One federated data plane: record identity + store retention.

    A plane never talks to the network itself; the network,
    ``sync_hubs`` and :class:`~repro_torch.core.gossip.GossipTopology`
    consult it when inserting records into a per-plane store
    (``dict[record_id, record]``), when encoding records for the wire,
    and when pricing them for bandwidth accounting.
    """

    name: str = "base"

    def key(self, item: Any) -> str:
        raise NotImplementedError

    def admit(self, store: dict[str, Any], item: Any) -> bool:
        """Insert ``item`` into a store. Returns True iff newly kept."""
        k = self.key(item)
        if k in store:
            return False
        store[k] = item
        self.evict(store)
        return k in store

    def evict(self, store: dict[str, Any]) -> None:
        """Store retention policy; default keeps everything."""

    def encode(self, item: Any) -> Any:
        """Wire encoding, applied once at the network ingress edge."""
        return item

    def payload_nbytes(self, item: Any) -> int:
        """Approximate bytes-on-wire of one record (bandwidth accounting)."""
        return 64  # bare metadata envelope; concrete planes override

    def forget_agent(self, agent_id: int) -> None:
        """Drop any per-sender codec state for a departed agent."""


class ERBPlane(SharePlane):
    """The paper's plane: experience replay buffers, kept forever."""

    name = "erb"

    def key(self, item: ERB) -> str:
        return item.meta.erb_id

    def payload_nbytes(self, item: ERB) -> int:
        return 64 + sum(np.asarray(v).nbytes for v in item.data.values())


class WeightPlane(SharePlane):
    """Parameter snapshots, deduplicated per source agent.

    Stores keep at most ``max_versions`` snapshots per agent (newest
    ``round_idx`` wins) and refuse re-insertion of snapshots no newer
    than what they already hold from that agent — so hub-hub sync never
    resurrects an evicted stale version.
    """

    name = "weights"

    def __init__(self, max_versions: int = 2):
        if max_versions < 1:
            raise ValueError(f"max_versions must be >= 1, got {max_versions}")
        self.max_versions = max_versions

    def key(self, item: WeightSnapshot) -> str:
        return item.snap_id

    def admit(self, store: dict[str, Any], item: WeightSnapshot) -> bool:
        if item.snap_id in store:
            return False
        newest = max(
            (s.round_idx for s in store.values() if s.agent_id == item.agent_id),
            default=None,
        )
        if newest is not None and item.round_idx <= newest:
            return False
        store[item.snap_id] = item
        self.evict(store)
        return item.snap_id in store

    def evict(self, store: dict[str, Any]) -> None:
        by_agent: dict[int, list[WeightSnapshot]] = {}
        for s in store.values():
            by_agent.setdefault(s.agent_id, []).append(s)
        for snaps in by_agent.values():
            snaps.sort(key=lambda s: (s.round_idx, s.snap_id), reverse=True)
            for stale in snaps[self.max_versions :]:
                del store[stale.snap_id]

    def payload_nbytes(self, item: Any) -> int:
        if isinstance(item, CompressedWeightSnapshot):
            return item.payload_nbytes
        # counted from the shapes: no host copy of a tree on the card
        return 32 + sum(x.numel() * x.element_size() for x in leaves(item.params))


class CompressedWeightPlane(WeightPlane):
    """Weight plane whose records cross the wire compressed.

    ``compression="int8"``: every snapshot is a dense int8-quantized
    tree — self-contained, ~4x smaller than float32.

    ``compression="topk"`` (default): the first snapshot from each agent
    is a dense int8 keyframe; each later one carries only the largest
    ``k_frac`` fraction of coordinates of the delta vs the sender's last
    *transmitted* state, int8-quantized.  Because the next delta is
    taken against the reconstruction (not the raw previous params), the
    untransmitted residual accumulates and is sent once it grows —
    sender-side error feedback.

    Dedup/retention semantics are inherited from :class:`WeightPlane`
    unchanged; only the wire format differs.
    """

    def __init__(
        self,
        max_versions: int = 2,
        compression: str = "topk",
        k_frac: float = 0.05,
    ):
        super().__init__(max_versions=max_versions)
        if compression not in ("int8", "topk"):
            raise ValueError(f"unknown compression: {compression!r}")
        self.compression = compression
        self.k_frac = float(k_frac)
        self._ref: dict[int, list[np.ndarray]] = {}  # per-sender transmitted state

    def forget_agent(self, agent_id: int) -> None:
        """Departed senders free their reference leaves."""
        self._ref.pop(agent_id, None)

    def encode(self, item: Any) -> Any:
        if isinstance(item, CompressedWeightSnapshot):
            return item  # already on the wire format (hub-hub relay)
        params = item.params
        treedef = tuple((k, n) for k in sorted(params) for n in sorted(params[k]))
        flat = _host_leaves(params)
        ref = self._ref.get(item.agent_id)
        qleaves: list[QuantizedLeaf] = []
        recon: list[np.ndarray] = []
        if self.compression == "int8" or ref is None:
            mode = "dense"
            for x in flat:
                q, scale = _quantize_int8(x.ravel())
                leaf = QuantizedLeaf(q, scale, x.shape)
                qleaves.append(leaf)
                recon.append(leaf.dequantize_dense())
        else:
            mode = "delta"
            for x, r in zip(flat, ref, strict=True):
                d = (x - r).ravel()
                k = max(1, int(round(self.k_frac * d.size)))
                idx = np.sort(np.argpartition(np.abs(d), -k)[-k:]).astype(np.int32)
                q, scale = _quantize_int8(d[idx])
                qleaves.append(QuantizedLeaf(q, scale, x.shape, idx=idx))
                rec = r.ravel().copy()
                rec[idx] += q.astype(np.float32) * scale
                recon.append(rec.reshape(x.shape))
        if self.compression == "topk":
            self._ref[item.agent_id] = recon
        payload = 32 + sum(leaf.nbytes for leaf in qleaves)
        return CompressedWeightSnapshot(
            item.snap_id,
            item.agent_id,
            item.round_idx,
            item.sim_time,
            mode,
            tuple(qleaves),
            treedef,
            payload,
            dense_params=_unflatten(treedef, recon) if mode == "delta" else None,
            version_vector=item.version_vector,
        )


# ---------------------------------------------------------------------------
# staleness weighting (FedAsync s(delta_tau) families)
# ---------------------------------------------------------------------------
def staleness_weight(
    delta_tau: float,
    flag: str = "poly",
    *,
    hinge_a: float = 10.0,
    hinge_b: float = 4.0,
    poly_a: float = 0.5,
) -> float:
    """FedAsync staleness discount ``s(delta_tau)``, clamped to (0, 1].

    ``constant``: 1 — staleness ignored (plain async averaging).
    ``hinge``:    1 until ``hinge_b`` rounds of lag, then 1/(a*(d-b)).
    ``poly``:     (d+1)^-a — smooth polynomial decay.
    """
    d = max(0.0, float(delta_tau))
    if flag == "constant":
        return 1.0
    if flag == "hinge":
        if d <= hinge_b:
            return 1.0
        return min(1.0, 1.0 / (hinge_a * (d - hinge_b)))
    if flag == "poly":
        return float((d + 1.0) ** (-poly_a))
    raise ValueError(f"unknown staleness flag: {flag!r}")


def staleness_alphas(
    snaps: Sequence[WeightSnapshot],
    now: float,
    *,
    alpha: float = 0.6,
    flag: str = "poly",
    hinge_a: float = 10.0,
    hinge_b: float = 4.0,
    poly_a: float = 0.5,
    clock: str = "round",
) -> np.ndarray:
    """Per-snapshot mixing rates ``alpha * s(now - tau_k)``.

    ``clock="round"``: ``tau_k`` is the sender's local round counter and
    ``now`` the receiver's (FedAsync-literal).  ``clock="time"``:
    ``tau_k`` is the snapshot's push time on the shared scheduler clock
    and ``now`` the receiver's current time — the right choice under
    heterogeneous agent speeds, where round counters are incomparable.
    """
    taus = [s.round_idx if clock == "round" else s.sim_time for s in snaps]
    out = [
        alpha
        * staleness_weight(
            now - tau, flag, hinge_a=hinge_a, hinge_b=hinge_b, poly_a=poly_a
        )
        for tau in taus
    ]
    return np.asarray(out, np.float64)


def snapshot_params(snap: Any) -> dict:
    """The float32 tree a snapshot carries, dequantizing if compressed."""
    if hasattr(snap, "dequantize"):
        return snap.dequantize()
    return snap.params


def mix_params(params: dict, snaps: Sequence[Any], alphas: Sequence[float]) -> dict:
    """Sequential FedAsync mixing: ``p <- (1-a_k) p + a_k w_k``.

    Snapshots are applied stalest-first on the shared clock (ascending
    ``sim_time``, then ``round_idx``, ties by id) so the freshest peer
    has the final word, whatever order the stores returned them in.
    Compressed snapshots are dequantized here, on the receiving side.
    The formula is the reference's, term for term (``torch.lerp``
    rounds differently); the result is new tensors on ``params``' device.
    """
    order = sorted(
        range(len(snaps)),
        key=lambda i: (snaps[i].sim_time, snaps[i].round_idx, snaps[i].snap_id),
    )
    for i in order:
        a = float(alphas[i])
        other = snapshot_params(snaps[i])
        params = {
            k: {
                n: (1.0 - a) * p + a * other[k][n].to(p.device)
                for n, p in layer.items()
            }
            for k, layer in params.items()
        }
    return params


__all__ = [
    "CompressedWeightPlane",
    "CompressedWeightSnapshot",
    "ERBPlane",
    "QuantizedLeaf",
    "SharePlane",
    "WeightPlane",
    "WeightSnapshot",
    "mix_params",
    "new_snap_id",
    "snapshot_params",
    "staleness_alphas",
    "staleness_weight",
]
