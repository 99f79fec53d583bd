"""Near-match suggestions for CLI name lookups.

Shared by the ``repro_torch.experiments`` and ``repro_torch.sweeps``
CLIs: an unknown ``--scenario``/``--sweep`` name exits nonzero with the
closest registered names instead of a raw ``KeyError`` traceback.
"""

from __future__ import annotations

import difflib
from collections.abc import Iterable


def close_matches(name: str, known: Iterable[str], *, n: int = 3) -> list[str]:
    """The registered names closest to ``name`` (possibly empty)."""
    known = sorted(known)
    matches = difflib.get_close_matches(name, known, n=n, cutoff=0.5)
    if not matches:  # fall back to prefix/substring hits
        matches = [k for k in known if name in k or k.startswith(name[:3])][:n]
    return matches


def unknown_name_message(kind: str, name: str, known: Iterable[str]) -> str:
    """One-line diagnostic: what was unknown, what was probably meant."""
    matches = close_matches(name, known)
    hint = (
        "did you mean: " + ", ".join(matches) + "?"
        if matches
        else "see --list for registered names"
    )
    return f"unknown {kind} {name!r}; {hint}"


__all__ = ["close_matches", "unknown_name_message"]
