"""The self time of replay planning over the fleet's window, in
percent: the program's ``fleet.plan`` wall spans (an agent's K replay
plans and the submit of its round) less the ``fleet.flush`` spans
nested in them (a submit flushes the engine while the slot still has a
round pending).  The window is the span readers' (``collect_share.fleet``).
None where the program records no such span or its tracer dropped
events."""

from pathlib import Path

from perfbench.harness.bench import load_module

_collect = load_module(Path(__file__).with_name("collect_share.fleet.py"))


def read(run):
    return _collect.self_share(run, "fleet.plan")
