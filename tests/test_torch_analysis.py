"""The port's linter (peritext_tpu_torch/analysis) against the reference
package's (peritext_tpu/analysis), on the reference's corpus, read-only.

The port carries all seven rules (and the PTL000 parse-error finding).
PTL001 and PTL005-PTL007 are ported unchanged: on the reference's corpus
the two give the same findings (rule, path, line, column, message,
context), and the two CLIs the same exit code and output on the same
input, the reference restricted to those four.  PTL002-PTL004 lint the
port's CUDA-graph-captured code (graph-cache bodies and marked capture
roots), of which JAX code has none: on the reference's corpus they find
nothing; tests/test_torch_capture_lint.py holds them against the
reference's on the torch twin of its corpus.  The port's self-scan is
clean modulo its own baseline,
``peritext_tpu_torch/graftlint_baseline.json``, every entry live and
justified.  The port reads and writes no other default baseline: an
update from outside the package exits 2 and leaves the JAX package's
baseline at the repo root, and the package's own, byte for byte as they
were.  The update tests that write a ledger on a scratch tree take that
tree as the package.
"""

import json
from pathlib import Path

import pytest

from peritext_tpu.analysis import scan_paths as jax_scan_paths
from peritext_tpu.analysis.__main__ import main as jax_main
from peritext_tpu_torch.analysis import (
    all_rule_ids,
    apply_baseline,
    find_default_baseline,
    load_baseline,
    rule_table,
    scan_paths,
    update_baseline,
)
from peritext_tpu_torch.analysis import baseline as port_baseline
from peritext_tpu_torch.analysis.__main__ import main
from peritext_tpu_torch.analysis.baseline import save_baseline

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "peritext_tpu_torch"
CORPUS = ROOT / "tests" / "graftlint_corpus"
TWINS = ROOT / "tests" / "graftlint_corpus_torch"
CARRIED = ["PTL001", "PTL002", "PTL003", "PTL004", "PTL005", "PTL006", "PTL007"]
#: the rules of captured code, held against the reference on the torch twin
TRACED = ["PTL002", "PTL003", "PTL004"]
UNCHANGED = [rule for rule in CARRIED if rule not in TRACED]
REF_RULES = ["--rules", ",".join(UNCHANGED)]


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.context)


def _ref_scan(path, root):
    """The reference's findings of the rules ported unchanged and PTL000."""
    return [f for f in jax_scan_paths([path], root=root) if f.rule not in TRACED]


@pytest.mark.parametrize("corpus", ["bad", "clean"])
def test_corpus_findings_equal_reference(corpus):
    got = scan_paths([CORPUS / corpus], root=ROOT)
    want = _ref_scan(CORPUS / corpus, ROOT)
    # JAX code has no graph-cache body and no capture root
    assert [f for f in got if f.rule in TRACED] == []
    assert [_key(f) for f in got] == [_key(f) for f in want]
    if corpus == "clean":
        assert got == []


@pytest.mark.parametrize("rule", CARRIED)
def test_every_carried_rule_has_a_true_positive(rule):
    corpus = TWINS if rule in TRACED else CORPUS
    assert any(f.rule == rule for f in scan_paths([corpus / "bad"], root=ROOT))


def test_parse_error_finding_equals_reference(tmp_path):
    bad = tmp_path / "parallel" / "broken.py"
    bad.parent.mkdir()
    bad.write_text("def f(:\n")
    got = scan_paths([bad], root=tmp_path)
    assert [f.rule for f in got] == ["PTL000"]
    assert [_key(f) for f in got] == [_key(f) for f in _ref_scan(bad, tmp_path)]


def test_ragged_insert_is_a_ragged_module(tmp_path):
    """PTL007 covers ops/ragged_insert.py, the port's counterpart of the
    reference's ragged_pallas.py, and no longer names that file."""
    src = "from ..utils.shapes import next_pow2\n\ndef f(n):\n    return next_pow2(n)\n"
    for name in ("ragged_insert.py", "ragged_pallas.py"):
        (tmp_path / name).write_text(src)
    assert [f.rule for f in scan_paths([tmp_path / "ragged_insert.py"], root=tmp_path)] == \
        ["PTL007", "PTL007"]
    assert scan_paths([tmp_path / "ragged_pallas.py"], root=tmp_path) == []


def test_rule_table_lists_exactly_the_carried_rules():
    from peritext_tpu.analysis import rule_table as jax_rule_table

    assert all_rule_ids() == CARRIED
    assert [row["id"] for row in rule_table()] == [row["id"] for row in jax_rule_table()]
    assert all(row["summary"] and row["rationale"] for row in rule_table())
    # the four rules ported unchanged keep the reference's words; the rules
    # of captured code speak of graph captures
    ref = {row["id"]: row for row in jax_rule_table()}
    ours = {row["id"]: row for row in rule_table()}
    assert [ours[rule] for rule in UNCHANGED] == [ref[rule] for rule in UNCHANGED]
    assert all("capture" in ours[rule]["summary"] and ours[rule]["scope"] == ref[rule]["scope"]
               for rule in TRACED)


def _cli(fn, argv, capsys):
    """(exit code, stdout, stderr) of one CLI call, the working directory
    spelled ``<cwd>``."""
    rc = fn(argv)
    out = capsys.readouterr()
    cwd = str(Path.cwd())
    return rc, out.out.replace(cwd, "<cwd>"), out.err.replace(cwd, "<cwd>")


@pytest.mark.parametrize("argv", [
    ["tests/graftlint_corpus/bad", "--no-baseline"],
    ["tests/graftlint_corpus/clean", "--no-baseline"],
    ["tests/graftlint_corpus/bad", "--no-baseline", "--format", "json"],
    ["tests/graftlint_corpus/bad", "--no-baseline", "--rules", "PTL005"],
    ["tests/graftlint_corpus/bad", "--no-baseline", "--rules", "PTL006,PTL007"],
    ["tests/graftlint_corpus/bad", "--rules", "PTL999"],
    ["tests/no_such_dir", "--no-baseline"],
], ids=["text", "clean", "json", "rules", "rules_pair", "unknown_rule", "missing_path"])
def test_cli_equals_reference(argv, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    ref_argv = argv if "--rules" in argv else argv + REF_RULES
    assert _cli(main, argv, capsys) == _cli(jax_main, ref_argv, capsys)


def _corpus_copy(tmp_path, name):
    """A scratch copy of the bad corpus under ``tmp_path/name``."""
    root = tmp_path / name
    for src in sorted((CORPUS / "bad").rglob("*.py")):
        dst = root / "pkg" / src.relative_to(CORPUS / "bad")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src.read_text())
    return root


def test_update_baseline_round_trip_equals_reference(tmp_path, capsys, monkeypatch):
    """--update-baseline at the scan root, a clean scan against it, a new
    finding past it, a stale entry after a fix, and a second update that
    keeps the hand-written justifications: the same codes, outputs and
    ledgers in both."""
    results = {}
    for name, fn, extra in (("port", main, []), ("ref", jax_main, REF_RULES)):
        root = _corpus_copy(tmp_path, name)
        monkeypatch.chdir(root)
        # the scratch tree stands for the port's package, the one place the
        # port's CLI writes a ledger (the reference writes at the scan root,
        # the same file here)
        monkeypatch.setattr(port_baseline, "PACKAGE_DIR", root)
        steps = [_cli(fn, ["pkg", "--update-baseline"] + extra, capsys)]
        ledger = root / "graftlint_baseline.json"
        entries = load_baseline(ledger)
        for e in entries.values():
            e.justification = f"kept {e.rule}"
        save_baseline(ledger, entries.values())
        steps.append(_cli(fn, ["pkg"] + extra, capsys))
        fresh = root / "pkg" / "parallel" / "fresh.py"
        fresh.write_text("import random\n\ndef f(xs):\n    random.shuffle(xs)\n")
        steps.append(_cli(fn, ["pkg"] + extra, capsys))
        fresh.unlink()
        lease = root / "pkg" / "parallel" / "lease_wallclock.py"
        lease.write_text("")  # its findings fixed: their entries go stale
        steps.append(_cli(fn, ["pkg"] + extra, capsys))
        steps.append(_cli(fn, ["pkg", "--update-baseline"] + extra, capsys))
        steps.append(json.loads(ledger.read_text()))
        results[name] = steps
    port, ref = results["port"], results["ref"]
    assert port[0][0] == 0 and port[1][0] == 0 and port[2][0] == 1 and port[3][0] == 0
    assert "stale baseline entry" in port[3][2]
    assert all(e["justification"].startswith("kept") for e in port[-1]["findings"])
    assert port == ref


def test_rules_scoped_update_keeps_other_entries(tmp_path, monkeypatch, capsys):
    scoped = tmp_path / "parallel"
    scoped.mkdir()
    (scoped / "v.py").write_text("import random, time\n\ndef f(xs):\n"
                                 "    random.shuffle(xs)\n    for x in set(xs):\n        pass\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_baseline, "PACKAGE_DIR", tmp_path)
    assert main(["parallel", "--update-baseline"]) == 0
    ledger = tmp_path / "graftlint_baseline.json"
    full = load_baseline(ledger)
    assert {e.rule for e in full.values()} == {"PTL001", "PTL006"}
    for e in full.values():
        e.justification = "kept"
    save_baseline(ledger, full.values())
    assert main(["parallel", "--rules", "PTL001", "--update-baseline"]) == 0
    after = load_baseline(ledger)
    assert {e.rule for e in after.values()} == {"PTL001", "PTL006"}
    assert all(e.justification == "kept" for e in after.values())
    capsys.readouterr()


def test_baseline_api_round_trip(tmp_path):
    findings = scan_paths([CORPUS / "bad"], root=ROOT)
    path = tmp_path / "baseline.json"
    save_baseline(path, update_baseline(findings, {}))
    entries = load_baseline(path)
    assert apply_baseline(findings, entries) == ([], [])
    new, stale = apply_baseline(findings[1:], entries)
    assert new == [] and len(stale) == 1


def test_package_baseline_is_found_first():
    """The package's own baseline, whatever is scanned: a walk up from a
    path outside the package would reach the JAX package's."""
    assert find_default_baseline() == PACKAGE / "graftlint_baseline.json"


@pytest.mark.parametrize("argv", [
    ["tests/graftlint_corpus/bad", "--update-baseline"],
    ["tests/graftlint_corpus/bad", "--rules", "PTL001", "--update-baseline"],
    ["peritext_tpu_torch/parallel", "--update-baseline", "--baseline",
     "graftlint_baseline.json"],
], ids=["scan_outside", "rules_scoped", "root_target"])
def test_update_outside_the_package_writes_nothing(argv, capsys, monkeypatch):
    """``--update-baseline`` from a path outside the package, or onto the
    repo root's baseline, exits 2 with a message; the root's baseline (the
    JAX package's) and the package's own keep their bytes."""
    monkeypatch.chdir(ROOT)
    files = (ROOT / "graftlint_baseline.json", PACKAGE / "graftlint_baseline.json")
    before = [f.read_bytes() for f in files]
    assert main(argv) == 2
    assert "refusing to update a baseline" in capsys.readouterr().err
    assert [f.read_bytes() for f in files] == before


def test_self_scan_clean_modulo_package_baseline():
    findings = scan_paths([PACKAGE], root=PACKAGE)
    entries = load_baseline(PACKAGE / "graftlint_baseline.json")
    new, stale = apply_baseline(findings, entries)
    assert new == [], "unbaselined findings:\n" + "\n".join(f.render() for f in new)
    assert stale == [], "stale entries: " + ", ".join(f"{e.rule} {e.path}" for e in stale)
    assert entries and all(e.justification and not e.justification.startswith("TODO")
                           for e in entries.values())
    # the fault boundaries carry annotations, not baseline entries
    assert not any(e.rule == "PTL005" for e in entries.values())


def test_cli_self_scan_exits_zero(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc, out, err = _cli(main, ["peritext_tpu_torch"], capsys)
    assert rc == 0, out + err
    assert out.startswith("graftlint: 0 finding(s)") and "stale" not in err
    assert _cli(main, [], capsys) == (rc, out, err)  # the default path is the package
