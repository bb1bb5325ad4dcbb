"""The port's AST lint (``analysis.lint``): RPL003–RPL007 give the
reference lint's (rule, line) findings on the fixtures of
``tests/test_analysis_lint.py``, the escape hatch and the CLI behave as
the reference's, and the port, ``chip_smoke.py`` and ``tools/`` lint
clean."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as rlint
from repro_torch.analysis.lint import (AST_RULES, RULES, lint_paths,
                                       lint_source, summarize)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's fixtures of RPL003-RPL007 (tests/test_analysis_lint.py):
# (source, path under the package root)
FIXTURES = {
    "rpl003_band": ("""
        ICI_BW = 45e9
        MASK = -1e30          # numeric sentinel: above the band
        N = 100_000_000       # below the band
        """, "launch/roofline.py"),
    "rpl003_configs_exempt": ("MIGRATION_BW_DEFAULT = 50e9\n",
                              "configs/base.py"),
    "rpl004_unguarded": ("""
        def step(self):
            self.tracer.instant("replan", args={"it": 3})
        """, "serving/engine.py"),
    "rpl004_guarded": ("""
        def step(self):
            if self.tracer.enabled:
                self.tracer.instant("replan", args={"it": 3})
            if self.profiler.enabled:
                self.profiler.observe_iter(moe_stats=s, tokens=4)
            gate.observe_iter(s)       # cost gate, not a profiler
        """, "serving/engine.py"),
    "rpl005_direct": ("""
        def hack(mgr, t):
            mgr.tables = t
        """, "serving/engine.py"),
    "rpl005_managers_exempt": ("""
        def commit(self, t):
            self.tables = t
        """, "replication/manager.py"),
    "rpl006_floats": ("""
        def plan(n):
            budget_bytes = n / 2
            slab_bytes = float(n)
            nbytes = 1.5
        """, "placement/migrate.py"),
    "rpl006_floor_div": ("""
        def plan(n):
            budget_bytes = n // 2
        """, "placement/migrate.py"),
    "rpl006_ledger_exempt": ("""
        def f(n):
            hbm_bytes = n * 0.53125
        """, "obs/ledger.py"),
    "rpl007_time_time": ("""
        def f():
            t0 = time.time()
            t1 = time.perf_counter()
        """, "launch/serve.py"),
    "rpl007_clock_seam_exempt": ("""
        def now():
            return time.time()
        """, "obs/trace.py"),
    "suppressed": ("""
        def f(n):
            budget_bytes = n / 2  # repro-lint: disable=RPL006
            t = time.time()  # repro-lint: disable=RPL003,RPL007
        """, "placement/migrate.py"),
    "mixed": ("""
        BW = 3.35e12
        def plan(self, n):
            self.rsets = None
            nbytes = n / 8
            self.profiler.observe_iter(n)
            return time.time()
        """, "serving/engine.py"),
}


def _found(findings):
    return sorted((f.rule, f.line, f.suppressed) for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_reference(name):
    code, rel = FIXTURES[name]
    code = textwrap.dedent(code)
    port = lint_source(code, f"repro_torch/{rel}")
    ref = [f for f in rlint.lint_source(code, f"repro/{rel}")
           if f.rule in AST_RULES]
    assert _found(port) == _found(ref)


def test_rules_catalog():
    assert sorted(RULES) == [f"RPL00{i}" for i in range(1, 8)]
    assert AST_RULES == ("RPL003", "RPL004", "RPL005", "RPL006", "RPL007")
    assert all("run time" in RULES[r] for r in ("RPL001", "RPL002"))


def test_syntax_error_reported_as_rpl000():
    assert [f.rule for f in lint_source("def f(:\n")] == ["RPL000"]


def test_port_lints_clean():
    """0 unsuppressed findings over the port, the smoke and the card's
    scripts; the suppressions are the documented ones."""
    findings = lint_paths([str(ROOT / "src" / "repro_torch"),
                           str(ROOT / "chip_smoke.py"), str(ROOT / "tools")])
    unsup = [f for f in findings if not f.suppressed]
    assert unsup == [], "\n".join(f.format() for f in unsup)
    sup = {(pathlib.Path(f.path).name, f.rule)
           for f in findings if f.suppressed}
    assert sup <= {("lint.py", "RPL003"), ("profiler.py", "RPL006")}
    assert summarize(findings)["files_ok"]


def test_cli_json_and_exit_codes(tmp_path):
    bad = tmp_path / "repro_torch" / "placement" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(n):\n    slab_bytes = n / 2\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint", str(bad)]
    r = subprocess.run(cmd + ["--json"], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 1
    out = json.loads(r.stdout)
    assert out["n_findings"] == 1 and out["by_rule"] == {"RPL006": 1}
    bad.write_text("def f(n):\n    slab_bytes = n / 2"
                   "  # repro-lint: disable=RPL006\n")
    r2 = subprocess.run(cmd, capture_output=True, text=True, env=env,
                        timeout=120)
    assert r2.returncode == 0 and "1 suppressed" in r2.stdout
