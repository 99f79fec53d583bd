"""The zoo's configs held to the reference's copies (not a test module).

The port's ``ModelConfig`` and ``MoEConfig`` carry fields the
reference's lack, for the port's own architectures (Kimi-Linear:
``prefix_mixer``, ``suffix``, ``kda``, ``MoEConfig.router``,
``routed_scale``, ``n_held``, ``held_offset``; Xing4.0: ``hc_mult``,
``MLAConfig.latent_norms``).  A copy of a reference
config equals it on every key the reference has, and holds each field
only the port has at its default."""

from __future__ import annotations

import dataclasses


def _defaults(obj) -> dict:
    return {f.name: f.default for f in dataclasses.fields(obj)}


def assert_reference_copy(got, want) -> None:
    """``got`` (the port's config) equals ``want`` (the reference's) on
    the reference's keys, nested groups too; the port's own fields are at
    their defaults."""
    mine, theirs = dataclasses.asdict(got), dataclasses.asdict(want)
    defaults = _defaults(got)
    for key in mine.keys() - theirs.keys():
        assert mine[key] == defaults[key], (got.name, key, mine[key])
    for key, value in theirs.items():
        if isinstance(value, dict) and isinstance(mine[key], dict):
            sub = getattr(got, key)
            for k in mine[key].keys() - value.keys():
                assert mine[key][k] == _defaults(sub)[k], (got.name, key, k)
            assert {k: mine[key][k] for k in value} == value, (got.name, key)
        else:
            assert mine[key] == value, (got.name, key)
