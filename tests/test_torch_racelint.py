"""The port's racelint, lint core and lock-order sanitizer
(``dalle_pytorch_tpu_torch/analysis/``) against the JAX package's.

The port's copy of every ``tests/test_racelint.py`` case, run from the
same corpus (``tests/fixtures/racelint/``, read only): exact agreement
with each fixture's ``# expect`` markers, the waivers, JSON, the CLI and
its exit codes, project mode on the cross pair, and the sanitizer. Then
parity with the JAX tool: equal ``RULES``; identical ``(path, line,
col, rule, message)`` lists on every corpus file and on the cross pair;
equal ``lock_order_edges`` over both packages; the port's
``serve/replica.py`` with its waivers stripped gives the same 5 RL003
findings under both. The gate: both tools find nothing in the port's
package and its three chip scripts. The runtime drive: the port's
``RequestQueue`` requeue after a drain, then two thread replicas at a
tiny width on the CPU through a drain with live migration, every lock
order seen one the static graph predicts.

AST-only and pure Python but for the drive, which runs the port's
engines on the CPU.
"""

import json
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from dalle_pytorch_tpu.analysis import racelint as JR
from dalle_pytorch_tpu_torch.analysis import guards
from dalle_pytorch_tpu_torch.analysis import racelint

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).parents[1]
PORT = ROOT / "dalle_pytorch_tpu_torch"
CHIP_SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "chip_replica_probe.py",
                ROOT / "chip_flash_variants.py"]
FIXTURES = Path(__file__).parent / "fixtures" / "racelint"
RULE_FILES = sorted(FIXTURES.glob("rl0*.py"))
ALL_FIXTURES = sorted(FIXTURES.glob("*.py"))
PAIR = [FIXTURES / "cross_order_a.py", FIXTURES / "cross_order_b.py"]
_EXPECT_RE = re.compile(r"#\s*expect:\s*(RL\d{3}(?:\s*,\s*RL\d{3})*)")
TOOLS = {"port": racelint, "jax": JR}


def expected_findings(path: Path):
    """(line, rule) pairs declared by `# expect: RLxxx` markers."""
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT_RE.search(line)
        if m:
            for rule in m.group(1).split(","):
                out.add((i, rule.strip()))
    return out


def rows(findings):
    return [(f.path, f.line, f.col, f.rule, f.message) for f in findings]


# -- the port's copy of tests/test_racelint.py ---------------------------------


class TestRuleCorpus:
    @pytest.mark.parametrize(
        "path", RULE_FILES, ids=[p.stem for p in RULE_FILES])
    def test_rule_fixture_exact_agreement(self, path):
        expected = expected_findings(path)
        assert expected, f"{path.name} has no # expect markers"
        actual = {(f.line, f.rule) for f in racelint.lint_file(path)}
        missed = expected - actual
        spurious = actual - expected
        assert not missed, f"rule went quiet, missed: {sorted(missed)}"
        assert not spurious, \
            f"flagged legal idiom lines: {sorted(spurious)}"

    def test_corpus_covers_every_rule(self):
        covered = set()
        for path in RULE_FILES:
            covered |= {rule for _, rule in expected_findings(path)}
        assert covered == set(racelint.RULES), \
            f"rules without a true-positive fixture: " \
            f"{sorted(set(racelint.RULES) - covered)}"

    def test_seeded_violation_fixture_is_dirty(self):
        findings = racelint.lint_file(FIXTURES / "seeded_violation.py")
        assert {f.rule for f in findings} >= {"RL003", "RL006"}


class TestSuppression:
    def test_suppressed_corpus_is_clean(self):
        """Every waiver form (trailing, line-above, slug, comma list,
        `all`) silences its finding."""
        assert racelint.lint_file(FIXTURES / "suppressed.py") == []

    @pytest.mark.parametrize("src, want", [
        # a waiver is line-scoped: the same violation one line later
        # without a comment still fires
        ("import time\n"
         "def f(t):\n"
         "    a = time.time() + t  # racelint: disable=RL006 — ok\n"
         "    b = time.time() + t\n"
         "    return a, b\n", [(4, "RL006")]),
        # an unknown rule id waives nothing
        ("import time\n"
         "def f(t):\n"
         "    return time.time() + t  # racelint: disable=RL999\n",
         [(3, "RL006")]),
        # a jaxlint waiver is inert for racelint
        ("import time\n"
         "def f(t):\n"
         "    return time.time() + t  # jaxlint: disable=JL007\n",
         [(3, "RL006")]),
        # the slug form waives too
        ("import time\n"
         "def f(t):\n"
         "    return time.time() + t  "
         "# racelint: disable=wallclock-deadline — ok\n", []),
    ], ids=["unwaived_sibling", "unknown_rule", "jaxlint_waiver", "slug"])
    def test_waiver_scope(self, src, want):
        got = [(f.line, f.rule) for f in racelint.lint_source(src)]
        assert got == want
        assert got == [(f.line, f.rule) for f in JR.lint_source(src)]


class TestCLI:
    def test_json_output_and_exit_code(self, capsys):
        rc = racelint.main(
            ["--json", "--no-default-excludes",
             str(FIXTURES / "seeded_violation.py")])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert out["files"] == 1
        rules = {f["rule"] for f in out["findings"]}
        assert "RL003" in rules and "RL006" in rules
        for f in out["findings"]:
            assert set(f) == {"rule", "slug", "path", "line", "col",
                              "message"}
            assert f["slug"] == racelint.RULES[f["rule"]][0]

    def test_clean_file_exits_zero(self, tmp_path, capsys):
        p = tmp_path / "clean.py"
        p.write_text("import time\nt0 = time.monotonic()\n")
        assert racelint.main([str(p)]) == 0

    def test_default_excludes_skip_own_corpus(self):
        assert racelint.iter_py_files([str(FIXTURES)]) == []
        files = racelint.iter_py_files([str(FIXTURES)], excludes=())
        assert len(files) >= 10
        assert racelint.DEFAULT_EXCLUDES == JR.DEFAULT_EXCLUDES

    def test_select_and_ignore(self, capsys):
        rc = racelint.main(["--json", "--select", "RL006",
                            "--no-default-excludes",
                            str(FIXTURES / "seeded_violation.py")])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert {f["rule"] for f in out["findings"]} == {"RL006"}
        rc = racelint.main(["--ignore", "RL003,RL006",
                            "--no-default-excludes",
                            str(FIXTURES / "seeded_violation.py")])
        capsys.readouterr()
        assert rc == 0

    @pytest.mark.parametrize("argv", [
        ["--select", "RL999", "x.py"],
        [str(FIXTURES / "no_such_dir")],
    ], ids=["unknown_rule", "no_files"])
    def test_usage_error_exits_two(self, argv, capsys):
        assert racelint.main(argv) == 2

    def test_parse_error_exits_two(self, tmp_path, capsys):
        p = tmp_path / "broken.py"
        p.write_text("def f(:\n")
        assert racelint.main([str(p)]) == 2
        assert "parse error" in capsys.readouterr().err

    def test_list_rules(self, capsys):
        assert racelint.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rid in racelint.RULES:
            assert rid in out

    def test_default_path_is_the_port(self, capsys, monkeypatch):
        monkeypatch.chdir(ROOT)
        assert racelint.main(["--json"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["findings"] == []
        assert out["files"] == len(racelint.iter_py_files([str(PORT)]))

    @pytest.mark.parametrize("args, rc", [
        (["--no-default-excludes", str(FIXTURES / "seeded_violation.py")],
         1),
        ([str(FIXTURES / "seeded_violation.py"),
          str(ROOT / "chip_replica_probe.py")], 0),
    ], ids=["seeded", "excluded"])
    def test_module_entrypoint_subprocess(self, args, rc):
        """``python -m dalle_pytorch_tpu_torch.analysis.racelint`` exits 1
        on the seeded fixture, 0 with it excluded by default."""
        proc = subprocess.run(
            [sys.executable, "-m",
             "dalle_pytorch_tpu_torch.analysis.racelint", *args],
            capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert proc.returncode == rc, proc.stderr
        assert "RuntimeWarning" not in proc.stderr


class TestCrossModule:
    _CROSS_RE = re.compile(r"#\s*cross-expect:\s*(RL\d{3})")

    def _expected(self):
        out = set()
        for p in PAIR:
            for i, line in enumerate(p.read_text().splitlines(),
                                     start=1):
                m = self._CROSS_RE.search(line)
                if m:
                    out.add((p.name, i, m.group(1)))
        return out

    def test_solo_mode_is_blind_to_the_pair(self):
        for p in PAIR:
            assert racelint.lint_file(p) == [], p.name

    def test_project_mode_exact_agreement(self):
        expected = self._expected()
        assert expected, "pair has no # cross-expect markers"
        assert {"RL002"} == {r for _, _, r in expected}
        actual = {(Path(f.path).name, f.line, f.rule)
                  for f in racelint.lint_files(PAIR)}
        assert actual == expected

    def test_pair_edges_exported(self):
        edges = racelint.lock_order_edges(PAIR)
        assert ("PeerA._la", "PeerB._lb") in edges
        assert ("PeerB._lb", "PeerA._la") in edges


# -- parity with the JAX package's racelint ------------------------------------


class TestParity:
    def test_rules_equal(self):
        assert racelint.RULES == JR.RULES

    @pytest.mark.parametrize(
        "path", ALL_FIXTURES, ids=[p.stem for p in ALL_FIXTURES])
    def test_lint_file_identical(self, path):
        got = rows(racelint.lint_file(path))
        assert got == rows(JR.lint_file(path))
        assert [f.to_dict() for f in racelint.lint_file(path)] \
            == [f.to_dict() for f in JR.lint_file(path)]

    def test_lint_files_identical_on_the_pair(self):
        got = rows(racelint.lint_files(PAIR))
        assert got and got == rows(JR.lint_files(PAIR))

    @pytest.mark.parametrize("pkg", ["dalle_pytorch_tpu",
                                     "dalle_pytorch_tpu_torch"])
    def test_lock_order_edges_equal(self, pkg):
        files = racelint.iter_py_files([str(ROOT / pkg)])
        edges = racelint.lock_order_edges(files)
        assert edges == JR.lock_order_edges(files)
        assert ("ReplicaSet._ctl_lock", "Engine._lock") in edges

    def test_port_graph_reaches_k4s_lock(self):
        """The engine's step holds its lock while K4's wrapper takes the
        module lock: the port's graph has that edge (through
        ``ops/decode.py::_step_counters``), and nothing is ordered after
        K4's lock."""
        edges = racelint.lock_order_edges(
            racelint.iter_py_files([str(PORT)]))
        assert ("Engine._lock", "paged_attention._LOCK") in edges
        assert not [e for e in edges if e[0] == "paged_attention._LOCK"]

    @pytest.mark.parametrize("tool", sorted(TOOLS))
    def test_stripped_replica_waivers_give_five_rl003(self, tool,
                                                      tmp_path):
        """The port's ``serve/replica.py`` without its five waivers, in a
        copy of the package, gives the five reshape-under-``_ctl_lock``
        RL003 findings, the same under both tools."""
        pkg = tmp_path / "dalle_pytorch_tpu_torch"
        shutil.copytree(PORT, pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = (pkg / "serve" / "replica.py").read_text()
        stripped = [ln for ln in src.splitlines(keepends=True)
                    if "# racelint: disable=" not in ln]
        assert len(src.splitlines()) - len(stripped) == 5
        (pkg / "serve" / "replica.py").write_text("".join(stripped))
        lint = TOOLS[tool]
        found = lint.lint_files(lint.iter_py_files([str(pkg)]))
        assert {(Path(f.path).name, f.rule) for f in found} \
            == {("replica.py", "RL003")}
        assert len(found) == 5
        assert all("ReplicaSet._ctl_lock" in f.message for f in found)
        other = TOOLS["jax" if tool == "port" else "port"]
        assert rows(found) == rows(
            other.lint_files(other.iter_py_files([str(pkg)])))


# -- the gate -----------------------------------------------------------------


class TestPortIsClean:
    @pytest.mark.parametrize("tool", sorted(TOOLS))
    def test_package_and_chip_scripts_lint_clean(self, tool):
        """Every concurrency finding in the port and its chip scripts is
        fixed or carries an in-line reasoned waiver, under both tools."""
        lint = TOOLS[tool]
        files = lint.iter_py_files([str(PORT)] + [str(p)
                                                  for p in CHIP_SCRIPTS])
        assert len(files) > 80
        findings = lint.lint_files(files)
        assert findings == [], "\n".join(x.render() for x in findings)


# -- the sanitizer --------------------------------------------------------------


class TestSanitizer:
    def test_inverted_order_raises(self):
        rec = guards.LockOrderRecorder()
        a = guards.TrackedLock("A._la", rec)
        b = guards.TrackedLock("B._lb", rec)
        with a:
            with b:
                pass
        with pytest.raises(guards.LockOrderError) as ei:
            with b:
                with a:
                    pass
        assert ei.value.first == "B._lb"
        assert ei.value.second == "A._la"
        assert rec.errors == [ei.value]
        # the inverting acquire left neither lock held
        assert not a.locked() and not b.locked()

    def test_transitive_inversion_caught(self):
        """A->B and B->C observed; C->A closes a 3-cycle even though
        the pair (C, A) was never seen directly."""
        rec = guards.LockOrderRecorder()
        la = guards.TrackedLock("A", rec)
        lb = guards.TrackedLock("B", rec)
        lc = guards.TrackedLock("C", rec)
        with la:
            with lb:
                pass
        with lb:
            with lc:
                pass
        with pytest.raises(guards.LockOrderError) as ei:
            with lc:
                with la:
                    pass
        assert ei.value.chain == ["A", "B", "C"]

    def test_consistent_order_is_silent(self):
        rec = guards.LockOrderRecorder()
        a = guards.TrackedLock("A", rec)
        b = guards.TrackedLock("B", rec)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert rec.edges() == {("A", "B")}
        assert rec.errors == []

    def test_tracked_lock_passthrough(self):
        rec = guards.LockOrderRecorder()
        lk = guards.TrackedLock("X", rec)
        assert lk.acquire(True, 0.1)
        assert lk.locked()
        # contended timed acquire fails without recording
        assert not lk.acquire(False)
        lk.release()
        assert not lk.locked()
        assert rec.edges() == set()

    def test_inversion_in_a_thread_that_swallows_it_is_kept(self):
        """The replica set takes any exception in a replica's step for a
        replica fault; the recorder still holds the inversion, and the
        thread left the lock free for the next one."""
        rec = guards.LockOrderRecorder()
        a = guards.TrackedLock("A", rec)
        b = guards.TrackedLock("B", rec)
        with a:
            with b:
                pass

        def replica_step():
            try:
                with b:
                    with a:
                        pass
            except Exception:   # noqa: BLE001 — a "replica fault"
                pass

        t = threading.Thread(target=replica_step)
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert [(e.first, e.second) for e in rec.errors] == [("B", "A")]
        assert a.acquire(False)
        a.release()

    def test_instrument_locks_names_wraps_and_restores(self):
        class Thing:
            def __init__(self):
                self._lock = threading.Lock()
                self.data = []
        t = Thing()
        raw = t._lock
        rec = guards.LockOrderRecorder()
        names = guards.instrument_locks(t, rec)
        assert names == ["Thing._lock"]
        assert isinstance(t._lock, guards.TrackedLock)
        with t._lock:
            pass
        # cls_name override: racelint names locks after the DEFINING
        # class, so a subclass instance must be instrumentable under
        # its base's name
        t2 = Thing()
        assert guards.instrument_locks(t2, rec, cls_name="Base") \
            == ["Base._lock"]
        assert guards.restore_locks(t) == ["Thing._lock"]
        assert t._lock is raw
        assert guards.restore_locks(t) == []

    def test_module_lock_takes_racelint_id(self):
        import torch
        from dalle_pytorch_tpu_torch import native
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        rec = guards.LockOrderRecorder()
        raw = PA._LOCK, native._lock
        try:
            assert guards.instrument_module_lock(PA, "_LOCK", rec) \
                == "paged_attention._LOCK"
            assert guards.instrument_module_lock(native, "_lock", rec) \
                == "native._lock"
            with native._lock:
                PA._counters(torch.device("cpu"), 4)
            assert rec.edges() == {("native._lock",
                                    "paged_attention._LOCK")}
        finally:
            guards.restore_locks(PA)
            guards.restore_locks(native)
            PA._COUNTERS.pop(torch.device("cpu"), None)
        assert (PA._LOCK, native._lock) == raw
        with pytest.raises(TypeError):
            guards.instrument_module_lock(PA, "SPLIT_ROWS", rec)

    def test_assert_consistent_with(self):
        rec = guards.LockOrderRecorder()
        with guards.TrackedLock("A", rec):
            with guards.TrackedLock("B", rec):
                pass
        rec.assert_consistent_with({("A", "B"), ("B", "C")})
        with pytest.raises(AssertionError, match="A -> B"):
            rec.assert_consistent_with({("B", "C")})

    def test_serve_drive_matches_static_graph(self):
        """The port's requeue after a drain fulfils the handle and
        summarizes its trace UNDER the queue lock; every runtime edge is
        one ``racelint.lock_order_edges`` predicts over the port."""
        from dalle_pytorch_tpu_torch.serve import scheduler
        rec = guards.LockOrderRecorder()
        q = scheduler.RequestQueue(max_depth=4)
        guards.instrument_locks(q, rec)
        h = q.submit(scheduler.Request(codes=(1, 2, 3)))
        guards.instrument_locks(h, rec)
        assert h.trace is not None
        guards.instrument_locks(h.trace, rec)
        q.close()
        q.drain()
        q.requeue(h)          # post-drain: fulfils under RequestQueue._lock
        assert h.done()
        observed = rec.edges()
        assert ("RequestQueue._lock", "RequestHandle._lock") in observed
        rec.assert_consistent_with(racelint.lock_order_edges(
            racelint.iter_py_files([str(PORT)])))

    def test_sanitizer_catches_seeded_inversion_against_static(self):
        rec = guards.LockOrderRecorder()
        with guards.TrackedLock("RequestHandle._lock", rec):
            with guards.TrackedLock("RequestQueue._lock", rec):
                pass
        with pytest.raises(AssertionError, match="not predicted"):
            rec.assert_consistent_with(racelint.lock_order_edges(
                racelint.iter_py_files([str(PORT)])))

    def test_replica_drain_with_migration_matches_static_graph(self):
        """Two thread replicas at a tiny width on the CPU, under the sync
        driver, through a drain of replica 0 with live migration, watched
        as ``chip_smoke.py``'s ``replicas`` phase watches the card's
        (``LockWatch``: the set's control lock and flight ring, the
        queue, each engine's locks and flight ring as it comes up, the
        handles and traces, K4's module lock): no inversion, every edge
        one the port's static graph predicts, and every lock plain
        again after. The drive reaches the control lock over an
        engine's (the migration's import), the queue's and the traces'."""
        import torch
        sys.path.insert(0, str(ROOT))
        import chip_smoke as CS
        from dalle_pytorch_tpu_torch.models import dalle as TD
        from dalle_pytorch_tpu_torch.models import vae as TV
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
        from dalle_pytorch_tpu_torch.serve import scheduler as S
        from dalle_pytorch_tpu_torch.serve.engine import Engine
        from dalle_pytorch_tpu_torch.serve.replica import (DRAINED,
                                                           ReplicaSet)
        cfg = TD.DALLEConfig(
            vae=TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=16,
                             num_layers=2, hidden_dim=8),
            dim=16, depth=2, num_text_tokens=50, text_seq_len=8, heads=2,
            dim_head=8)
        model = TD.dalle_init(cfg, seed=3, device="cpu")
        q = S.RequestQueue(max_depth=16)
        rs = ReplicaSet(model, q, replicas=2, num_slots=2, chunk_steps=4,
                        kv="paged", page_size=8, paged_attn="kernel",
                        device="cpu", bringup_policy=RetryPolicy(
                            max_attempts=1, deadline_s=None,
                            base_backoff_s=0.01, backoff_multiplier=2.0,
                            max_backoff_s=0.1, jitter=0.0))
        init, lock = Engine.__init__, PA._LOCK
        watch = CS.LockWatch(rs, q)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        watch.start()
        try:
            # one request a replica: replica 1 keeps a slot free to land
            # replica 0's in
            handles = [watch.submit(S.Request(codes=(3 + i, 7, 9),
                                              seed=11 + i))
                       for i in range(2)]
            for _ in range(3):
                rs.step_once()
            assert [r.engine.active_slots() for r in rs.replicas] == [1, 1]
            assert rs.drain_replica(0) == 1
            assert rs.replicas[0].state == DRAINED
            rs.run_until_idle()
        finally:
            watch.stop()
            torch.set_num_threads(threads)
            rs.close()
        assert Engine.__init__ is init and PA._LOCK is lock
        assert all(guards.restore_locks(o) == [] for o in watch.objs)
        assert all(h.result(timeout=0).status == S.OK for h in handles)
        assert rs.stats()["migrations"] == 1
        assert watch.rec.errors == []
        observed = watch.rec.edges()
        assert {("ReplicaSet._ctl_lock", "Engine._lock"),
                ("ReplicaSet._ctl_lock", "RequestQueue._lock"),
                ("ReplicaSet._ctl_lock", "Trace._lock")} <= observed
        watch.rec.assert_consistent_with(racelint.lock_order_edges(
            racelint.iter_py_files([str(PORT)])))


# -- K4's split counters, fetched once a step -----------------------------------


class TestStepCounters:
    """``ops/decode.py::_step_counters`` fetches K4's split counters once
    a step through ``PA.split_counters``, the call through which the
    static graph sees the engine's lock ordered over K4's (the layers'
    reads are callbacks it cannot follow). Off the card there are
    none: the plain version takes no counters."""

    @pytest.mark.parametrize("kv_dtype, dh, slices", [
        ("float32", 64, 1), ("bfloat16", 128, 1), ("bfloat16", 256, 1),
        ("int8", 192, 1), ("float32", 192, 2), ("float32", 256, 2),
        ("bfloat16", 320, 3)])
    def test_slices_match_the_wide_body(self, kv_dtype, dh, slices):
        import torch
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        dtype = getattr(torch, kv_dtype)
        assert PA._slices(dtype, dh) == slices
        assert (slices > 1) == (PA.kernel_body(dtype, dh)
                                == "paged_decode_wide_kernel")

    def test_none_off_the_card(self):
        import torch
        from dalle_pytorch_tpu_torch.ops import decode as TDEC
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        assert PA.split_counters("cpu", 8, 8, 64, torch.float32) is None
        pool = {"k": torch.zeros((2, 5, 2, 8, 8))}
        assert TDEC._step_counters(pool, 4, "kernel") is None
        assert TDEC._step_counters(pool, 4, "gather") is None
        assert torch.device("cpu") not in PA._COUNTERS
