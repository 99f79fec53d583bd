"""Multi-seed sweep grids over the scenario registry.

One frozen :class:`SweepSpec` (scenario × seeds × overrides) expands
into a deterministic grid of derived
:class:`~repro_torch.experiments.spec.ScenarioSpec` cells; a process-pool
executor runs the missing cells (resuming from the on-disk JSONL
:class:`ReportStore`), and the aggregation layer folds per-seed reports
into mean ± 95% CI summaries with paired t-test / permutation-test
significance between variants.  Every cell runs on the CUDA card
unless ``device="cpu"`` (CLI: ``--device cpu``) is given:

    from repro_torch import sweeps
    summary = sweeps.run_sweep(sweeps.get_sweep("paper_table1_sweep"), fast=True)

or from the shell:

    python -m repro_torch.sweeps --list
    python -m repro_torch.sweeps --sweep paper_table1_sweep --fast --json out.json
    python -m repro_torch.sweeps --compare old.json new.json
"""

from repro_torch.sweeps.aggregate import (  # noqa: F401
    GATE_METRICS,
    compare,
    forgetting_of,
    summarize,
)
from repro_torch.sweeps.executor import (  # noqa: F401
    default_workers,
    failed_cells,
    run_sweep,
)
from repro_torch.sweeps.registry import (  # noqa: F401
    get_sweep,
    list_sweeps,
    register_sweep,
)
from repro_torch.sweeps.spec import (  # noqa: F401
    DEFAULT_METRICS,
    SweepCell,
    SweepSpec,
    SweepVariant,
    apply_overrides,
    spec_hash,
)
from repro_torch.sweeps.stats import (  # noqa: F401
    mean_ci,
    paired_permutation_test,
    paired_ttest,
    t_crit,
    t_sf,
)
from repro_torch.sweeps.store import ReportStore  # noqa: F401
