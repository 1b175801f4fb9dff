"""repro-lint over the port (``repro_torch.analysis``), on the CPU.

Twins every test of ``tests/test_analysis.py`` with torch idiom in the
fixtures: one violating + one clean fixture per lint rule (the host-sync
regions are ``torch.compile`` functions, CUDA-graph captures and
``make_graphed_callables`` callables; the unseeded-RNG rule also covers
torch's process-global generator), inline and baseline suppression, the
fault-site coverage contract (synthetic repo + the port, whose crash tests
live in ``tests/test_torch_recovery.py`` and ``tests/test_torch_online.py``),
the whole-port green gate, the serialization regressions on the port's
``ServiceSnapshot`` and ``DynamismJournal``, and the rebuild sentinel: a
real growth run on the CPU in steady state (zero rebuilds after warm-up,
the DiDiC table refreshes counted and never findings), the tight-headroom
schedule, and two runs that must fail (a forced compaction and a cleared
store cache). The shared rule families are held to the JAX lint on the
same fixtures.
"""

import contextlib
import dataclasses
import json
import pathlib
import textwrap

import pytest
import torch

import repro_torch.analysis as A
from repro_torch import builds
from repro_torch.analysis import recompile
from repro_torch.analysis.framework import RepoContext
from repro_torch.analysis.faultsites import COVERAGE_TESTS, check_fault_sites
from repro_torch.analysis.placement import check_single_owner

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO_ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"


def _lint(tmp_path, code, rules=None, name="snippet.py"):
    f = tmp_path / name
    f.write_text(textwrap.dedent(code))
    return A.lint_file(f, rules=rules)


def _rules(findings):
    return [f.rule for f in findings]


@contextlib.contextmanager
def _cpu_group():
    """A one-rank gloo group for the service's replay mesh (none opened
    when one is open already)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import open_group

    opened = open_group(torch.device("cpu"))
    try:
        yield
    finally:
        if opened:
            dist.destroy_process_group()


def _growth_runtime(scale=0.002, maintenance="shared"):
    """The sentinel's service and runtime (filesystem, random parts, shared
    maintenance on a one-rank mesh) on the CPU; needs an open group."""
    from repro_torch.core import partitioners
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import generate_ops
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh

    g = datasets.load("filesystem", scale=scale, seed=1)
    svc = PartitionedGraphService(
        g, 4, didic=DidicConfig(k=4, iterations=4),
        mesh=make_replay_mesh(device="cpu"), maintenance=maintenance,
    )
    svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0))
    ops = generate_ops(g, n_ops=48, seed=3)
    rt = DynamicExperimentRuntime(svc, insert_method="fewest_vertices", seed=0)
    return g, svc, ops, rt


# ===========================================================================
# determinism rules
# ===========================================================================
class TestDeterminismRules:
    def test_wall_clock_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import time as _t
            from datetime import datetime

            def stamp():
                a = _t.time()
                b = datetime.now()
                return a, b
        """, rules=["determinism/wall-clock"])
        assert len(found) == 2
        assert all(r == "determinism/wall-clock" for r in _rules(found))

    def test_wall_clock_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import time
            import torch

            def duration(fn):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        """, rules=["determinism/wall-clock"])
        assert found == []

    def test_unseeded_rng_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import random
            import numpy as np
            from numpy.random import default_rng

            def draw():
                a = default_rng()                # unseeded
                b = np.random.SeedSequence()     # unseeded
                c = np.random.rand(3)            # global numpy RNG
                d = random.random()              # global stdlib RNG
                return a, b, c, d
        """, rules=["determinism/unseeded-rng"])
        assert len(found) == 4

    def test_unseeded_rng_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import random
            import numpy as np
            import torch

            def draw(seed):
                rng = np.random.default_rng(seed)
                ss = np.random.SeedSequence(seed)
                r = random.Random(seed)
                gen = torch.Generator().manual_seed(seed)
                t = torch.rand(3, generator=gen)
                return rng.integers(0, 4), ss, r.random(), t
        """, rules=["determinism/unseeded-rng"])
        assert found == []

    def test_torch_global_rng_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import torch
            from torch import randn as _randn

            def init(n):
                torch.manual_seed(0)                   # reseeds the global generator
                torch.cuda.manual_seed_all(0)          # ... and every card's
                a = torch.rand(n)                      # global draws
                b = _randn(n, 4)
                c = torch.randint(0, 4, (n,))
                d = torch.randperm(n)
                e = torch.normal(0.0, 1.0, (n,))
                f = torch.bernoulli(a)
                g = torch.multinomial(a, 2)
                return a, b, c, d, e, f, g
        """, rules=["determinism/unseeded-rng"])
        assert _rules(found) == ["determinism/unseeded-rng"] * 9
        assert {f.line for f in found} == set(range(6, 15))

    def test_torch_seeded_generator_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            def init(n, seed, device):
                gen = torch.Generator(device=device)
                gen.manual_seed(seed)                  # a generator of its own
                a = torch.rand(n, generator=gen, device=device)
                b = torch.randn((n, 4), generator=torch.Generator().manual_seed(1))
                c = torch.randint(0, 4, (n,), generator=gen)
                d = torch.randperm(n, generator=gen)
                e = torch.multinomial(a, 2, generator=gen)
                f = torch.zeros(n).uniform_(generator=gen)
                return a, b, c, d, e, f
        """, rules=["determinism/unseeded-rng"])
        assert found == []

    def test_id_keyed_cache_violating(self, tmp_path):
        found = _lint(tmp_path, """
            CACHE = {}

            def lookup(graph, d):
                CACHE[id(graph)] = 1
                m = {id(graph): 2}
                return d.get(id(graph)), m
        """, rules=["determinism/id-keyed-cache"])
        assert len(found) == 3

    def test_id_keyed_cache_clean(self, tmp_path):
        found = _lint(tmp_path, """
            CACHE = {}

            def lookup(graph, d):
                key = graph.fingerprint()
                CACHE[key] = 1
                return d.get(key)
        """, rules=["determinism/id-keyed-cache"])
        assert found == []

    def test_unordered_serialization_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import json

            def fingerprint(d):
                out = []
                for k, v in d.items():
                    out.append((k, v))
                return json.dumps(dict(out))
        """, rules=["determinism/unordered-serialization"])
        assert len(found) == 2  # unsorted .items() + dumps w/o sort_keys

    def test_unordered_serialization_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import json

            def fingerprint(d):
                out = []
                for k, v in sorted(d.items()):
                    out.append((k, v))
                return json.dumps(dict(out), sort_keys=True)

            def not_a_serialization_path(d):
                # same constructs outside a fingerprint/to_bytes path: fine
                return [k for k in d.items()], json.dumps(d)
        """, rules=["determinism/unordered-serialization"])
        assert found == []


# ===========================================================================
# host-sync rules
# ===========================================================================
class TestHostSyncRules:
    def test_item_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            @torch.compile
            def step(x):
                return x.item()
        """, rules=["host-sync/item"])
        assert _rules(found) == ["host-sync/item"]

    def test_item_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            @torch.compile
            def step(x, table):
                return x + len(table.items())  # .items() != .item()

            def host_side(x):
                return x.item()  # not a traced region
        """, rules=["host-sync/item"])
        assert found == []

    def test_host_cast_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            f = torch.compile(lambda x: int(x))

            @torch.compile(fullgraph=True)
            def g(x):
                return float(x[0])
        """, rules=["host-sync/host-cast"])
        assert len(found) == 2

    def test_host_cast_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            @torch.compile
            def g(x):
                n = int(x.shape[0])    # static under trace
                m = int(x.size(1)) + int(x.numel()) + int(x.dim())
                return x * n * m
        """, rules=["host-sync/host-cast"])
        assert found == []

    def test_np_on_tracer_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import numpy as np
            import torch

            def body(x):
                return np.asarray(x)

            graphed = torch.cuda.make_graphed_callables(body, (torch.zeros(4),))
        """, rules=["host-sync/np-on-tracer"])
        assert _rules(found) == ["host-sync/np-on-tracer"]

    def test_np_on_tracer_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import numpy as np
            import torch

            LUT = [1, 2, 3]
            f = torch.compile(lambda x: x + np.asarray(LUT)[0])  # host constant
        """, rules=["host-sync/np-on-tracer"])
        assert found == []

    def test_cuda_graph_bodies_are_traced(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            def capture(g, static_x):
                with torch.cuda.graph(g):
                    y = static_x * 2
                    total = y.sum().item()
                return total
        """, rules=["host-sync/item"])
        assert _rules(found) == ["host-sync/item"]
        assert found[0].line == 7

    def test_to_host_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import functools
            import torch

            @functools.partial(torch.compile, dynamic=False)
            def step(x):
                return x.cpu(), torch.sum(x).numpy()

            def fwd(a):
                return a.tolist()

            def bwd(a):
                return a.numpy()

            graphed = torch.cuda.make_graphed_callables((fwd, bwd), ((torch.zeros(2),), (torch.zeros(2),)))
        """, rules=["host-sync"])
        assert sorted(_rules(found)) == ["host-sync/item"] + ["host-sync/to-host"] * 3

    def test_to_host_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import torch

            TABLE = torch.arange(4)

            @torch.compile
            def step(x):
                return x.to(torch.float32) + TABLE.cpu()   # a module constant

            def capture(g, x):
                with torch.cuda.graph(g):
                    y = x * 2
                return y.cpu()                               # after the capture

            def host(x):
                return x.cpu().numpy()
        """, rules=["host-sync"])
        assert found == []


# ===========================================================================
# counter-dtype rule
# ===========================================================================
class TestCounterDtypeRule:
    def test_raw_accumulation_violating(self, tmp_path):
        found = _lint(tmp_path, """
            import numpy as np
            import torch

            class Tally:
                def fold(self, wave, total, mesh, scatter_psum):
                    self.total += torch.sum(wave, dtype=torch.int32)
                    total += wave.sum(dtype="int32")
                    total -= np.sum(wave, dtype=np.int32)
                    total += mesh.psum(wave)
                    self.rows += scatter_psum(wave, wave)
                    return total
        """, rules=["counter-dtype"])
        assert len(found) == 5

    def test_raw_accumulation_clean(self, tmp_path):
        found = _lint(tmp_path, """
            import numpy as np
            import torch

            class Tally:
                def fold(self, acc, wave, scatter):
                    acc.add(scatter(wave))            # the sanctioned hand-off
                    self.total += wave.cpu().numpy().astype(np.int64)
                    self.total += torch.sum(wave, dtype=torch.int64)
                    n = torch.sum(wave, dtype=torch.int32)   # not an accumulation
                    return n
        """, rules=["counter-dtype"])
        assert found == []


# ===========================================================================
# suppression + baseline mechanics
# ===========================================================================
class TestSuppression:
    def test_inline_disable(self, tmp_path):
        found = _lint(tmp_path, """
            import time

            def stamp():
                a = time.time()  # repro-lint: disable=determinism/wall-clock
                b = time.time()  # repro-lint: disable
                c = time.time()
                return a, b, c
        """, rules=["determinism/wall-clock"])
        assert len(found) == 1 and found[0].line == 7

    def test_baseline_key_is_line_independent(self, tmp_path):
        v1 = _lint(tmp_path, "import time\nt = time.time()\n",
                   rules=["determinism/wall-clock"], name="a.py")
        v2 = _lint(tmp_path, "import time\n\n\n# moved\nt = time.time()\n",
                   rules=["determinism/wall-clock"], name="b.py")
        assert v1[0].line != v2[0].line
        assert v1[0].key.split("|", 2)[2] == v2[0].key.split("|", 2)[2]

    def test_baseline_roundtrip_and_staleness(self, tmp_path):
        found = _lint(tmp_path, "import time\nt = time.time()\n",
                      rules=["determinism/wall-clock"])
        bl_path = tmp_path / "baseline.json"
        A.write_baseline(found, bl_path)
        baseline = A.load_baseline(bl_path)
        new, suppressed, stale = A.split_by_baseline(found, baseline)
        assert (new, len(suppressed), stale) == ([], 1, [])
        new, suppressed, stale = A.split_by_baseline([], baseline)
        assert new == [] and suppressed == [] and len(stale) == 1


# ===========================================================================
# fault-site coverage
# ===========================================================================
class TestFaultSiteCoverage:
    def test_real_repo_every_fired_site_registered_and_tested(self):
        """The acceptance check: every site fired under src/repro_torch is
        in FAULT_SITES and exercised by the port's crash tests."""
        ctx = RepoContext(root=REPO_ROOT, files=A.iter_source_files(REPO_ROOT))
        findings = list(check_fault_sites(ctx))
        assert findings == [], [f.format() for f in findings]

    def test_synthetic_unknown_untested_unfired(self, tmp_path):
        src = tmp_path / "src" / "repro_torch"
        src.mkdir(parents=True)
        (src / "svc.py").write_text(textwrap.dedent("""
            def cycle(plan):
                plan.fire("apply:pre_commit")
                plan.fire("totally-bogus-site")
                plan.fire(dynamic_site)
        """))
        ctx = RepoContext(root=tmp_path, files=[src / "svc.py"])
        found = list(check_fault_sites(ctx))
        by_rule = {}
        for f in found:
            by_rule.setdefault(f.rule, []).append(f)
        assert len(by_rule["fault-sites/unknown"]) == 1      # bogus site
        assert len(by_rule["fault-sites/dynamic"]) == 1      # non-literal
        assert len(by_rule["fault-sites/untested"]) == 1     # no tests dir
        # all registered sites but the one fired above are unfired here
        from repro_torch.core.fault import FAULT_SITES
        assert len(by_rule["fault-sites/unfired"]) == len(FAULT_SITES) - 1

    def test_serve_sites_are_covered_by_the_online_tests(self, tmp_path):
        """``serve:admit`` is crashed only in the online server's tests:
        with the recovery tests alone as coverage it is untested."""
        from repro_torch.analysis.faultsites import tested_sites

        assert COVERAGE_TESTS == ("tests/test_torch_recovery.py",
                                  "tests/test_torch_online.py")
        recovery_only = tested_sites(REPO_ROOT, COVERAGE_TESTS[:1])
        both = tested_sites(REPO_ROOT)
        assert "serve:admit" not in recovery_only
        assert {"serve:admit", "serve:commit", "maintain", "apply:compact"} <= both


# ===========================================================================
# placement single-owner
# ===========================================================================
class TestPlacementSingleOwner:
    def test_direct_parts_write_violating(self, tmp_path):
        src = tmp_path / "src" / "repro_torch"
        src.mkdir(parents=True)
        (src / "svc.py").write_text(textwrap.dedent("""
            def migrate(svc, v, dst):
                svc.parts[v] = dst          # bypasses Placement
                parts[v] = dst              # bare name, same problem
                parts[v] += 1               # augmented write too
        """))
        ctx = RepoContext(root=tmp_path, files=[src / "svc.py"])
        found = list(check_single_owner(ctx))
        assert _rules(found) == ["placement/single-owner"] * 3

    def test_allowlisted_and_clean(self, tmp_path):
        src = tmp_path / "src" / "repro_torch" / "core"
        src.mkdir(parents=True)
        # partitioners.py legitimately builds fresh local parts arrays
        (src / "partitioners.py").write_text(textwrap.dedent("""
            def hash_partition(n, k):
                parts[ids] = ids % k
                return parts
        """))
        # clean module: new array under another name, assigned via setter
        (src / "runtime.py").write_text(textwrap.dedent("""
            def commit(svc, new_parts, moved, dst):
                out = new_parts.copy()
                out[moved] = dst
                svc.parts = out
                svc.placement.invalidate(moved)
        """))
        ctx = RepoContext(root=tmp_path,
                          files=[src / "partitioners.py", src / "runtime.py"])
        assert list(check_single_owner(ctx)) == []

    def test_real_repo_is_single_owner(self):
        ctx = RepoContext(root=REPO_ROOT, files=A.iter_source_files(REPO_ROOT))
        found = list(check_single_owner(ctx))
        assert found == [], [f.format() for f in found]


# ===========================================================================
# whole-port gate + regressions for the findings the linter surfaced
# ===========================================================================
class TestRepoIsClean:
    def test_static_rules_green_against_baseline(self):
        """``python -m repro_torch.analysis --no-recompile`` finds nothing
        new, against an empty baseline."""
        findings = A.run_lint(REPO_ROOT)
        baseline = A.load_baseline(BASELINE)
        assert baseline == {}
        new, _suppressed, _stale = A.split_by_baseline(findings, baseline)
        assert new == [], [f.format() for f in new]

    def test_dryrun_timers_are_monotonic(self):
        found = A.lint_file(REPO_ROOT / "src" / "repro_torch" / "launch" / "dryrun.py",
                            root=REPO_ROOT, rules=["determinism/wall-clock"])
        assert found == []

    def test_online_admission_loop_is_simulated_clock_only(self):
        """The online server's bit-exactness contract requires the
        admission loop to run on the simulated tick clock — no wall-clock
        reads anywhere in core/online."""
        found = A.lint_file(REPO_ROOT / "src" / "repro_torch" / "core" / "online.py",
                            root=REPO_ROOT, rules=["determinism/wall-clock"])
        assert found == []

    def test_paper_tables_total_is_a_duration(self):
        """Regression (determinism/wall-clock): the tables' ``_total_wall_s``
        row was timed with time.time()."""
        found = A.lint_file(REPO_ROOT / "src" / "repro_torch" / "paper_tables.py",
                            root=REPO_ROOT, rules=["determinism"])
        assert found == []

    def test_cli_no_recompile_exits_zero(self, tmp_path, capsys):
        from repro_torch.analysis.__main__ import main

        jp = tmp_path / "lint.json"
        assert main(["--root", str(REPO_ROOT), "--no-recompile", "--json", str(jp)]) == 0
        payload = json.loads(jp.read_text())
        assert payload["ok"] and payload["recompile_sentinel"] is None
        assert "OK" in capsys.readouterr().out

    def test_cli_sentinel_without_cuda_raises(self, monkeypatch):
        """No silent CPU fallback: the sentinel runs on the card unless
        ``--device cpu`` is given."""
        from repro_torch.analysis.__main__ import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--root", str(REPO_ROOT), "--slices", "1"])


class TestSerializationDeterminismRegressions:
    """Identical state must serialize to identical bytes regardless of
    dict insertion order, in the port's snapshot and journal."""

    def _runtime(self, g):
        from repro_torch.core.didic import DidicConfig
        from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
        from repro_torch.core.framework import PartitionedGraphService
        from repro_torch.core.traffic import generate_ops

        svc = PartitionedGraphService(g, 4, didic=DidicConfig(k=4, iterations=6),
                                      device="cpu")
        svc.partition_didic(seed=0)
        rt = DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=7)
        ops = generate_ops(g, n_ops=60, seed=3)
        rt.begin(ops)
        return rt, ops

    def test_snapshot_bytes_independent_of_meta_order(self):
        from repro_torch.core.recovery import ServiceSnapshot
        from repro_torch.graphs import datasets

        g = datasets.load("filesystem", scale=0.001, seed=1)
        rt, _ = self._runtime(g)
        snap = ServiceSnapshot.capture(rt, g, next_slice=0)
        permuted = ServiceSnapshot(
            meta=dict(reversed(list(snap.meta.items()))), arrays=snap.arrays
        )
        permuted.verify()  # checksum was already canonical
        assert permuted.to_bytes() == snap.to_bytes()

    def test_snapshot_bytes_independent_of_attr_order(self):
        from repro_torch.core.recovery import ServiceSnapshot
        from repro_torch.graphs import datasets

        g = datasets.load("filesystem", scale=0.001, seed=1)
        assert len(g.node_attrs) >= 2  # permutation must be non-trivial
        rt, _ = self._runtime(g)
        g_perm = dataclasses.replace(
            g, node_attrs=dict(reversed(list(g.node_attrs.items())))
        )
        a = ServiceSnapshot.capture(rt, g, next_slice=0)
        b = ServiceSnapshot.capture(rt, g_perm, next_slice=0)
        assert a.to_bytes() == b.to_bytes()

    def test_journal_bytes_independent_of_entry_order(self):
        from repro_torch.core import partitioners
        from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
        from repro_torch.core.recovery import DynamismJournal
        from repro_torch.graphs import datasets

        g = datasets.load("filesystem", scale=0.001, seed=1)
        svc = PartitionedGraphService(g, 4, device="cpu")
        svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0))
        svc.journal = journal = DynamismJournal()
        ip = InsertPartitioner("random", 4, seed=0)
        for i in range(3):
            journal.mark_slice(i)
            svc.apply_dynamism(ip.allocate(
                svc.parts, 0.03, insert_rate=0.5, graph=svc.graph))

        reordered = DynamismJournal()
        reordered._next_seq = journal._next_seq
        reordered._current_slice = journal._current_slice
        for fp, e in reversed(list(journal.entries.items())):
            reordered.entries[fp] = e
        assert reordered.to_bytes() == journal.to_bytes()
        restored = DynamismJournal.from_bytes(reordered.to_bytes())
        assert [e.seq for e in restored.entries.values()] == [0, 1, 2]


# ===========================================================================
# rebuild sentinel
# ===========================================================================
class TestRecompileSentinel:
    def test_classification_synthetic(self):
        E = recompile.CompileEvent
        events = [
            E("warmup", "f", "(8, 16)"),
            E("slice0", "g", "(8, 16)"),
            E("slice1", "f", "(9, 18)"),     # shape change
            E("slice2", "g", "(8, 16)"),     # same geometry -> identity
            E("slice2", "h", "(2, 4)"),      # never seen -> new closure
        ]
        got = {(r.closure, r.cause) for r in recompile.classify(events)}
        assert got == {
            ("f", "shape-change"),
            ("g", "identity-rehash"),
            ("h", "new-closure"),
        }

    def test_growth_schedule_steady_state_zero_rebuilds(self):
        """Steady-state mode: the store sizes every growth-facing buffer to
        its capacity and the built objects adopt each grown graph, so all
        building lands in the warm-up slices (begin replay + slice 0, where
        ``prepare_growth`` attaches the store) and every later slice builds
        *nothing*. The DiDiC overlay tables are refreshed at each
        maintenance slice and counted, never findings."""
        report = recompile.run_growth_sentinel(
            slices=3, scale=0.001, n_ops=24, maintain_every=2, device="cpu",
        )
        assert report["service_device"] == "cpu"
        assert report["tensor_devices"] == ["cpu"]
        # growth happened...
        nodes = [s["n_nodes"] for s in report["per_slice"]]
        assert nodes == sorted(nodes) and nodes[-1] > nodes[0]
        # ...building all happened during warm-up (slice 0 included)
        assert report["per_slice"][0]["rebuilds"] > 0
        assert {e["name"] for e in report["warmup_builds"]} == {
            "engine:filesystem", "replayer:filesystem"}
        assert report["total_rebuilds_after_warmup"] == 0
        assert report["steady_state"]
        assert report["retraces"] == []
        # the tables: built by prepare_growth (slice 0), refreshed by the
        # maintenance of slice 1, untouched in slice 2
        assert [s["refreshes"] for s in report["per_slice"]] == [1, 1, 0]
        assert report["total_refreshes"] == 2
        # zero rebuilds -> zero findings -> nothing for baseline.json
        assert recompile.findings_from_report(report, REPO_ROOT) == []
        growth_entries = [k for k in A.load_baseline(BASELINE)
                          if "recompile/growth-retrace" in k]
        assert growth_entries == []

    def test_tight_headroom_stays_zero_rebuild(self, monkeypatch):
        """REPRO_GROWTH_HEADROOM=1.25 still reaches zero post-warm-up
        rebuilds on the sentinel's 20x5% schedule when the growth stays
        inside the reserved capacity. The insert rate is chosen so 20
        slices grow ~16% (< 25%), so the store must never compact (a
        compaction would rebuild)."""
        monkeypatch.setenv("REPRO_GROWTH_HEADROOM", "1.25")
        with _cpu_group():
            g, svc, ops, rt = _growth_runtime()
            n0 = g.n_nodes
            after_warmup = 0
            with recompile.capture_builds() as cap:
                cap.slice_label = "warmup"
                rt.begin(ops)
                for i in range(20):
                    cap.slice_label = f"slice{i}"
                    before = len(cap.events)
                    rt.run_slice(i, ops, 0.05, maintain_every=6, insert_rate=0.15)
                    if i >= 1:
                        after_warmup += len(cap.events) - before
        store = svc.graph.store
        assert store.headroom == 1.25
        assert svc.graph.n_nodes > n0 * 1.05          # growth really ran
        assert svc.graph.n_nodes <= store.n_cap       # ...inside capacity
        assert store.compactions == 0
        assert after_warmup == 0
        assert len(cap.refreshes) == 4                # slices 0, 5, 11, 17

    def test_forced_compaction_is_a_shape_change(self, monkeypatch):
        """The sentinel can fail: a headroom too small for one slice's
        growth compacts the store at slice 1, and the engine and the
        replayer are built again at the new capacity."""
        monkeypatch.setenv("REPRO_GROWTH_HEADROOM", "1.05")
        report = recompile.run_growth_sentinel(slices=3, device="cpu")
        assert report["compactions"] >= 1
        assert report["total_rebuilds_after_warmup"] > 0
        assert report["per_slice"][1]["rebuilds"] == 2
        got = {(r["closure"], r["cause"]): r["slices"] for r in report["retraces"]}
        assert got[("engine:filesystem", "shape-change")][0] == "slice1"
        assert got[("replayer:filesystem", "shape-change")][0] == "slice1"
        findings = recompile.findings_from_report(report, REPO_ROOT)
        assert {f.path for f in findings} == {
            "src/repro_torch/core/traffic_batched.py",
            "src/repro_torch/core/traffic_sharded.py",
        }
        assert {f.rule for f in findings} == {"recompile/growth-retrace"}

    def test_cleared_store_cache_is_an_identity_rehash(self):
        """The sentinel can fail: a store cache emptied between slices makes
        the next slice build the engine and the replayer again at the same
        capacity."""
        with _cpu_group():
            _, svc, ops, rt = _growth_runtime(scale=0.001)
            with recompile.capture_builds() as cap:
                cap.slice_label = "warmup"
                rt.begin(ops)
                for i in range(3):
                    cap.slice_label = f"slice{i}"
                    if i == 2:
                        svc.graph.store.caches.clear()
                    rt.run_slice(i, ops, 0.05, maintain_every=10, insert_rate=0.5)
        retraces = recompile.classify(cap.events)
        assert {(r.closure, r.cause, tuple(r.slices)) for r in retraces} == {
            ("engine:filesystem", "identity-rehash", ("slice2",)),
            ("replayer:filesystem", "identity-rehash", ("slice2",)),
        }

    def test_sharded_maintenance_builds_one_mesh_program(self):
        """With sharded maintenance the capacity mesh program is built once,
        in slice 0, and its halo tables are refreshed at each maintenance
        slice: refreshes, not rebuilds."""
        with _cpu_group():
            _, svc, ops, rt = _growth_runtime(scale=0.001, maintenance="sharded")
            with recompile.capture_builds() as cap:
                cap.slice_label = "warmup"
                rt.begin(ops)
                for i in range(4):
                    cap.slice_label = f"slice{i}"
                    rt.run_slice(i, ops, 0.05, maintain_every=2, insert_rate=0.5)
        built = [(e.slice_label, e.name) for e in cap.events]
        assert ("slice0", "mesh_program") in built
        assert all(label in ("warmup", "slice0") for label, _ in built)
        assert recompile.classify(cap.events) == []
        assert [(e.slice_label, e.name) for e in cap.refreshes] == [
            ("slice0", "mesh_program_tables"), ("slice1", "mesh_program_tables"),
            ("slice3", "mesh_program_tables")]

    def test_kernel_library_build_is_an_event(self, monkeypatch):
        """A kernel's library counts as a build at its source hash; after
        warm-up it maps to its CUDA source."""
        from repro_torch.kernels import KERNELS

        kernel = KERNELS["bell_matmul"]
        monkeypatch.setattr(kernel, "_start_build", lambda: None)  # no nvcc here
        with recompile.capture_builds() as cap:
            cap.slice_label = "slice3"
            kernel.build()
        assert [(e.name, e.shapes) for e in cap.events] == [
            ("kernel:bell_matmul", str((kernel.library_path().stem,)))]
        report = {"retraces": [r.to_json() for r in recompile.classify(cap.events)]}
        (finding,) = recompile.findings_from_report(report, REPO_ROOT)
        assert finding.path == "src/repro_torch/csrc/bell_matmul.cu"
        assert "new-closure" in finding.message

    def test_build_hook_is_inert_without_a_listener(self):
        calls = []
        assert builds._LISTENERS == []
        builds.note_build("engine:x", (1, 2))       # no listener: nothing
        listener = lambda *a: calls.append(a)  # noqa: E731
        builds.add_listener(listener)
        try:
            builds.note_build("engine:x", (1, 2))
            builds.note_refresh("didic_tables", (3, 4))
        finally:
            builds.remove_listener(listener)
        assert builds._LISTENERS == []
        assert calls == [("build", "engine:x", (1, 2)),
                         ("refresh", "didic_tables", (3, 4))]


class TestReporting:
    def test_report_payload_and_text(self, tmp_path):
        from repro_torch.analysis import report as R

        found = _lint(tmp_path, "import time\nt = time.time()\n",
                      rules=["determinism/wall-clock"])
        payload = R.build_payload(found, [], [])
        text = R.render_text(found, [], [])
        assert payload["ok"] is False and "FAIL" in text
        jp, tp = tmp_path / "r.json", tmp_path / "r.txt"
        R.write_reports(payload, text, json_path=jp, text_path=tp)
        assert json.loads(jp.read_text())["new_findings"][0]["rule"] == \
            "determinism/wall-clock"
        assert "repro-lint" in tp.read_text()

    def test_sentinel_text_names_rebuilds_and_refreshes(self):
        from repro_torch.analysis import report as R

        rep = {"schedule": {"slices": 2, "amount": 0.05, "insert_rate": 0.5},
               "device": "cpu", "total_rebuilds_after_warmup": 0,
               "total_refreshes": 1, "steady_state": True, "retraces": [],
               "per_slice": [
                   {"slice": 0, "rebuilds": 2, "refreshes": 1, "seconds": 0.02, "n_nodes": 10},
                   {"slice": 1, "rebuilds": 0, "refreshes": 0, "seconds": 0.01, "n_nodes": 11}]}
        text = R.render_text([], [], [], rep)
        assert "rebuilds after slice 0: 0 (steady-state: yes); table refreshes: 1" in text
        assert "slice  0:   2 rebuilds   1 refreshes" in text


# ===========================================================================
# the shared rule families against the JAX lint
# ===========================================================================
_SHARED_FIXTURES = {
    "determinism": """
        import json
        import random
        import time
        from datetime import datetime
        import numpy as np

        CACHE = {}

        def stamp(graph, d):
            CACHE[id(graph)] = time.time()
            rng = np.random.default_rng()
            return datetime.now(), np.random.rand(2), random.random(), rng, d.get(id(graph))

        def fingerprint(d):
            return json.dumps([k for k in d.keys()]), [v for v in set(d)]

        def ok(seed):
            return time.perf_counter(), np.random.default_rng(seed)
    """,
    "suppression": """
        import time

        def stamp():
            a = time.time()  # repro-lint: disable=determinism/wall-clock
            b = time.time()  # repro-lint: disable
            c = time.time()
            return a, b, c
    """,
}


class TestParityWithJax:
    @pytest.mark.parametrize("fixture", sorted(_SHARED_FIXTURES))
    def test_shared_rules_find_what_jax_finds(self, tmp_path, fixture):
        import repro.analysis as JA

        f = tmp_path / "shared.py"
        f.write_text(textwrap.dedent(_SHARED_FIXTURES[fixture]))
        ours = A.lint_file(f, rules=["determinism"])
        theirs = JA.lint_file(f, rules=["determinism"])
        assert ours, "the fixture must violate something"
        assert [(x.rule, x.line, x.snippet) for x in ours] == \
            [(x.rule, x.line, x.snippet) for x in theirs]
        assert [x.key for x in ours] == [x.key for x in theirs]

    def test_registry_and_rule_ids(self):
        import repro.analysis as JA
        from repro.core.fault import FAULT_SITES as JAX_SITES
        from repro_torch.analysis.faultsites import registry_sites

        assert registry_sites() == dict(JAX_SITES)
        jax_rules = set(JA.RULES)
        assert jax_rules <= set(A.RULES)
        assert set(A.RULES) - jax_rules == {"host-sync/to-host"}

    def test_classifier_matches_jax(self):
        from repro.analysis import recompile as jr

        rows = [("warmup", "f", "a"), ("slice0", "g", "a"), ("slice1", "f", "b"),
                ("slice2", "g", "a"), ("slice2", "h", "c"), ("slice3", "f", "b"),
                ("slice3", "f", "a"), ("slice4", "h", "d")]
        ours = recompile.classify([recompile.CompileEvent(*r) for r in rows])
        theirs = jr.classify([jr.CompileEvent(*r) for r in rows])
        assert [(r.closure, r.cause, r.count, r.slices) for r in ours] == \
            [(r.closure, r.cause, r.count, r.slices) for r in theirs]

    def test_baseline_files_interchange(self, tmp_path):
        import repro.analysis as JA

        f = tmp_path / "t.py"
        f.write_text("import time\nt = time.time()\n")
        bl = tmp_path / "baseline.json"
        JA.write_baseline(JA.lint_file(f), bl)
        new, suppressed, stale = A.split_by_baseline(A.lint_file(f), A.load_baseline(bl))
        assert (new, len(suppressed), stale) == ([], 1, [])
