"""repro-lint for the port: the repo's static invariant analysis over
``src/repro_torch`` (twin of ``repro.analysis``).

The port's headline claims — bit-exact recovery, the paper's §6.4 "1%
maintenance cost" result, the delta overlay's zero-rebuild growth — rest
on structural invariants that these rules check mechanically:

**AST rule families** (see each module's docstring for the rationale):

* ``determinism/*``  (:mod:`~repro_torch.analysis.determinism`) — no
  wall-clock reads, unseeded/global RNG (numpy's, the stdlib's and
  torch's process-global generator), ``id()``-keyed caches, or
  hash-order-dependent serialization in fingerprint/snapshot paths.
* ``host-sync/*``    (:mod:`~repro_torch.analysis.hostsync`) — no
  ``.item()`` / ``.cpu()`` / host casts / ``np.asarray`` on device values
  inside ``torch.compile`` regions and CUDA-graph captures.
* ``counter-dtype/*`` (:mod:`~repro_torch.analysis.counterdtype`) — int32
  device counter folds must route through the
  ``distributed/counters.py`` int64 hand-off.
* ``fault-sites/*``  (:mod:`~repro_torch.analysis.faultsites`, repo
  scope) — every site fired via ``FaultPlan.fire`` must exist in
  ``core.fault.FAULT_SITES`` and be exercised by a crash test.
* ``placement/*``    (:mod:`~repro_torch.analysis.placement`, repo
  scope) — partition ownership is only mutated through the ``Placement``
  API.

**Rebuild sentinel** (:mod:`~repro_torch.analysis.recompile`) — drives a
real growth schedule with the port's build hook
(:mod:`repro_torch.builds`) listening and reports which objects holding a
device program or its buffers are built again per slice and why
(``shape-change`` / ``identity-rehash`` / ``new-closure``). Runs in
steady-state mode: any post-warm-up rebuild is a lint failure (no
baseline entries), not tracked debt.

**Workflow**: ``python -m repro_torch.analysis`` fails only on findings
*not* in ``baseline.json`` (deferred findings stay listed in every report,
so debt is visible); ``--write-baseline`` refreshes the baseline after a
deliberate deferral. Suppress single lines with
``# repro-lint: disable=<rule>``, whole files via ``FILE_CONFIG``.
Adding a rule = write a generator taking a :class:`FileContext` (or
:class:`RepoContext`), decorate with
:func:`repro_torch.analysis.framework.rule`, import the module here, and
add violating+clean fixtures to ``tests/test_torch_analysis.py``.
"""

from repro_torch.analysis.framework import (  # noqa: F401
    FILE_CONFIG,
    LINT_ROOTS,
    RULES,
    FileContext,
    Finding,
    RepoContext,
    iter_source_files,
    lint_file,
    load_baseline,
    run_lint,
    split_by_baseline,
    write_baseline,
)

# Importing the rule modules registers their rules.
from repro_torch.analysis import counterdtype  # noqa: E402,F401
from repro_torch.analysis import determinism  # noqa: E402,F401
from repro_torch.analysis import faultsites  # noqa: E402,F401
from repro_torch.analysis import hostsync  # noqa: E402,F401
from repro_torch.analysis import placement  # noqa: E402,F401
