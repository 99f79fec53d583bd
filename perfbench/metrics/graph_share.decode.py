"""The share of the process's decode steps that replayed a CUDA graph,
in percent, set-up included: of the port's count of serve steps by route
(``models/model.py``: ``make_serve_step.steps_by_route``, the steps run
eagerly, captured and replayed), the replays over all of them.  None
where the count has no ``replay`` key (a program that captures no
decode graph) or counts no step."""


def share(steps_by_route: dict) -> float | None:
    if "replay" not in steps_by_route:
        return None
    total = sum(steps_by_route.values())
    return 100.0 * steps_by_route["replay"] / total if total else None


def read(run):
    from repro_torch.models.model import make_serve_step

    return share(getattr(make_serve_step, "steps_by_route", {}))
