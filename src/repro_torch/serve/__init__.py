"""Online inference plane: continuous-batching localization serving.

A request queue and a continuous-batching :class:`LocalizationService`
over the batched act program (pow2 batch buckets), and a
:class:`ParamPublisher` that hot-swaps fleet params out of a live
training engine between ticks (train-while-serve with a
bounded-staleness version ring).  The port of the reference's
``repro/serve``:

    from repro_torch.serve import (
        LocalizationService, ParamPublisher, ServeRequest,
        TrafficSpec, synthetic_requests,
    )
"""

from repro_torch.serve.driver import ServeSession, build_session, run_session
from repro_torch.serve.publisher import ParamPublisher, ParamVersion
from repro_torch.serve.queue import RequestQueue, ServeRequest, ServeResult
from repro_torch.serve.report import RequestRecord, ServeReport
from repro_torch.serve.service import LocalizationService
from repro_torch.serve.traffic import TrafficSpec, synthetic_requests

__all__ = [
    "LocalizationService",
    "ParamPublisher",
    "ParamVersion",
    "RequestQueue",
    "RequestRecord",
    "ServeReport",
    "ServeRequest",
    "ServeResult",
    "ServeSession",
    "TrafficSpec",
    "build_session",
    "run_session",
    "synthetic_requests",
]
