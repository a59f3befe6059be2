"""repro_torch.analysis: per-rule TP/TN fixtures with exact counts,
KERNEL-CONTRACT on a fixture kernel tree and on the port's own kernels,
suppression, baselines, the CLI's exit codes and JSON report, the port's
tree being clean, parity with the reference checker on its OBS-GATE and
DEPRECATION fixtures, and the dispatch-level host-sync check on the CPU."""
import ast
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import AnalysisConfig as RefConfig  # noqa: E402
from repro.analysis import run_analysis as ref_run_analysis  # noqa: E402
from repro.analysis.report import render_json as ref_render_json  # noqa: E402
from repro.analysis.report import render_text as ref_render_text  # noqa: E402
from repro_torch.analysis import AnalysisConfig, RULES, run_analysis  # noqa: E402
from repro_torch.analysis import baseline as baseline_mod  # noqa: E402
from repro_torch.analysis import dispatch_tools  # noqa: E402
from repro_torch.analysis.cli import main  # noqa: E402
from repro_torch.analysis.config import default_config  # noqa: E402
from repro_torch.analysis.report import render_json, render_text  # noqa: E402

TESTS = Path(__file__).resolve().parent
FIXTURES = TESTS / "fixtures" / "torch_analysis"
REF_FIXTURES = TESTS / "fixtures" / "analysis"
REPO_ROOT = TESTS.parent
RULE_IDS = ("DEPRECATION", "HOSTSYNC", "KERNEL-CONTRACT", "OBS-GATE",
            "RNG-DISCIPLINE")


def _flat_cfg(**over):
    base = dict(root=str(FIXTURES), index_globs=("*.py",))
    base.update(over)
    return AnalysisConfig(**base)


def _tp_lines(name):
    """Lines of fixture ``name`` marked ``# TP``: where its findings go."""
    text = (FIXTURES / name).read_text().splitlines()
    return [i for i, line in enumerate(text, start=1) if "# TP" in line]


_CONFIGS = {
    "hostsync": _flat_cfg(
        hostsync_hot={"hostsync_tp.py": ("*._decode_live",),
                      "hostsync_tn.py": ("to_host", "*._decode_live")},
        hostsync_allow=(("hostsync_tn.py", "to_host", ".cpu"),)),
    "rng": _flat_cfg(rng_scope=("*.py",), rng_allow=(("*.py", "*init*"),)),
    "obsgate": _flat_cfg(obsgate_hot={
        f"obsgate_{kind}.py": ("*.push", "*._decode_live", "*._observe")
        for kind in ("tp", "tn")}),
}


# -- the four file rules: exact true positives, clean true negatives --------
@pytest.mark.parametrize("rule_id,stem,count", [
    ("HOSTSYNC", "hostsync", 11), ("RNG-DISCIPLINE", "rng", 6),
    ("OBS-GATE", "obsgate", 2)])
def test_rule_true_positives(rule_id, stem, count):
    result = run_analysis(_CONFIGS[stem], [f"{stem}_tp.py"])
    assert [f.rule for f in result.findings] == [rule_id] * count
    assert [f.line for f in result.findings] == _tp_lines(f"{stem}_tp.py")
    assert result.suppressed == 0


@pytest.mark.parametrize("stem,suppressed", [
    ("hostsync", 1), ("rng", 0), ("obsgate", 0)])
def test_rule_true_negatives(stem, suppressed):
    result = run_analysis(_CONFIGS[stem], [f"{stem}_tn.py"])
    assert result.findings == []
    assert result.suppressed == suppressed


def test_hostsync_names_each_sync():
    result = run_analysis(_CONFIGS["hostsync"], ["hostsync_tp.py"])
    keys = [f.message.split(" in hot-path")[0][1:-1]
            for f in result.findings]
    assert keys == [".item", ".tolist", ".cpu", ".numpy", ".to('cpu')",
                    ".to('cpu')", "torch.equal", "torch.cuda.synchronize",
                    ".synchronize", ".synchronize", "np.asarray"]
    assert {f.symbol for f in result.findings} == {"Engine._decode_live"}


def test_deprecation_tp_and_tn():
    cfg = AnalysisConfig(root=str(FIXTURES / "depr"),
                         index_globs=("**/*.py",),
                         deprecation_scope=("mod.py",),
                         test_globs=("tests/*.py",))
    result = run_analysis(cfg, ["mod.py"])
    assert [f.rule for f in result.findings] == ["DEPRECATION"] * 2
    assert {f.symbol for f in result.findings} == {"old_sample",
                                                   "legacy_merge"}


# -- KERNEL-CONTRACT ----------------------------------------------------------
def _kernel_cfg(root):
    return AnalysisConfig(root=str(root), index_globs=("**/*.py",),
                          kernels_dir="kernels", smoke_path="smoke.py",
                          test_globs=("tests/*.py",))


@pytest.mark.parametrize("kernel,why", [
    ("short_list", "takes 5 parameter(s) but build.ENTRY_POINTS declares 4"),
    ("short_call", "passes 4 argument(s) but build.ENTRY_POINTS"),
    ("fallback", "'ref.fallback' in an except handler"),
    ("unchecked", "smoke.py does not hold it against its plain version"),
])
def test_kernel_contract_fixture_faults(kernel, why):
    result = run_analysis(_kernel_cfg(FIXTURES / "kproj"), ["kernels"])
    assert {f.rule for f in result.findings} == {"KERNEL-CONTRACT"}
    assert len(result.findings) == 4
    mine = [f for f in result.findings if kernel in f.message]
    assert len(mine) == 1 and why in mine[0].message, mine
    assert not any("'good'" in f.message for f in result.findings)


def test_kernel_contract_real_kernels_are_clean():
    result = run_analysis(default_config(str(REPO_ROOT)),
                          ["src/repro_torch/kernels"])
    assert result.findings == []
    assert result.files_checked >= 4


def _kernel_tree_copy(tmp_path):
    """The port's kernels (sources, build, wrappers, plain versions) under
    ``tmp_path``, beside links to the real tests and on-card check."""
    src = REPO_ROOT / "src" / "repro_torch" / "kernels"
    dst = tmp_path / "src" / "repro_torch" / "kernels"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tests").symlink_to(TESTS)
    (tmp_path / "chip_smoke.py").symlink_to(REPO_ROOT / "chip_smoke.py")
    return dst


@pytest.mark.parametrize("path,old,new,whys", [
    ("build.py", "[_I] + [_P] * 8 + [_I] * 8 + [_P]),\n    \"paged_prefill",
     "[_I] + [_P] * 8 + [_I] * 7 + [_P]),\n    \"paged_prefill",
     ["takes 18 parameter(s) but build.ENTRY_POINTS declares 17",
      "_launch('paged_decode_attention', ...) passes 18 argument(s)"]),
    ("csrc/cayley_neumann.cu", "void* rot, int L, int r, int terms,",
     "void* rot, int L, float r, int terms,", ["parameter 5 of cayley_neumann_launch "
                                    "('float r') is other"]),
    ("ops.py", "        return ref.cayley_neumann_series(q, terms)",
     "        pass\n    if q.ndim == 0:\n"
     "        return ref.cayley_neumann_series(q, terms)",
     ["'ref.cayley_neumann_series' outside an 'if _on_cpu(...)'"]),
    ("build.py", '"gather_delta_matmul", "psoft_matmul", "cayley_neumann",',
     '"gather_delta_matmul", "psoft_matmul",',
     ["kernel 'cayley_neumann': csrc/cayley_neumann.cu is not in "
      "build.SOURCES"]),
])
def test_kernel_contract_reads_the_real_tree(tmp_path, path, old, new, whys):
    """One planted fault in a copy of the port's kernels gives exactly the
    findings it should: the rule reads the real prototypes, lists and
    launch calls, not a fixture's."""
    kdir = _kernel_tree_copy(tmp_path)
    target = kdir / path
    text = target.read_text()
    assert text.count(old) == 1, "anchor moved; update this test"
    target.write_text(text.replace(old, new))
    result = run_analysis(default_config(str(tmp_path)),
                          ["src/repro_torch/kernels"])
    got = [f.message for f in result.findings]
    assert len(got) == len(whys), got
    assert all(any(w in m for m in got) for w in whys), got


# -- the port's own tree --------------------------------------------------------
def test_port_tree_is_clean():
    """The acceptance gate: nothing found in src/repro_torch with no
    baseline, in-process."""
    result = run_analysis(default_config(str(REPO_ROOT)), ["src/repro_torch"])
    assert result.findings == [], [str(f) for f in result.findings]
    assert result.files_checked > 60
    assert not (REPO_ROOT / "analysis-baseline-torch.json").exists()


def test_cli_clean_run_and_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = main(["--root", str(REPO_ROOT), "src/repro_torch/kernels",
               "--no-baseline", "--format", "json", "--output", str(out)])
    assert rc == 0, capsys.readouterr().out
    report = json.loads(out.read_text())
    assert set(report) == {"version", "files_checked", "suppressed",
                           "baselined", "findings"}
    assert report["findings"] == [] and report["files_checked"] >= 4


def _seeded_engine(tmp_path):
    """A copy of the engine with a ``.item()`` planted in ``_decode_live``."""
    engine = REPO_ROOT / "src" / "repro_torch" / "serve" / "engine.py"
    dst = tmp_path / "src" / "repro_torch" / "serve" / "engine.py"
    dst.parent.mkdir(parents=True)
    anchor = "        toks = np.zeros((self.slots, 1), np.int32)\n"
    text = engine.read_text()
    assert text.count(anchor) == 1, "seed anchor moved; update this test"
    dst.write_text(text.replace(
        anchor, "        _probe = self.positions.sum().item()\n" + anchor))
    return dst


def test_cli_exit_codes_and_baseline(tmp_path, capsys):
    _seeded_engine(tmp_path)
    out = tmp_path / "report.json"
    rc = main(["--root", str(tmp_path), "--format", "json", "--output",
               str(out)])
    capsys.readouterr()
    assert rc == 1
    found = json.loads(out.read_text())["findings"]
    assert [(f["rule"], f["symbol"]) for f in found] == [
        ("HOSTSYNC", "ServeEngine._decode_live")]
    # grandfathered into the port's own default baseline, then clean
    assert main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert (tmp_path / "analysis-baseline-torch.json").exists()
    capsys.readouterr()
    assert main(["--root", str(tmp_path)]) == 0
    assert "1 baselined" in capsys.readouterr().out
    assert main(["--root", str(tmp_path), "--no-baseline"]) == 1
    # usage errors
    assert main(["--root", str(tmp_path / "missing")]) == 2
    with pytest.raises(SystemExit) as exc:
        main(["--format", "xml"])
    assert exc.value.code == 2


def _import_roots(nodes):
    """Top-level packages the absolute imports among ``nodes`` name."""
    out = set()
    for n in nodes:
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and not n.level:
            out.add((n.module or "").split(".")[0])
    return out


def test_checker_is_stdlib_only():
    """No module of the checker imports the reference, jax or numpy, and
    only dispatch_tools imports torch, inside its functions."""
    pkg = REPO_ROOT / "src" / "repro_torch" / "analysis"
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text())
        roots = _import_roots(ast.walk(tree))
        assert not roots & {"repro", "jax", "numpy", "repro_torch"}, path
        assert "torch" not in _import_roots(tree.body), path
        if path.name != "dispatch_tools.py":
            assert "torch" not in roots, path


def test_cli_lists_the_five_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == list(RULE_IDS)
    assert sorted(RULES) == sorted(RULE_IDS)


def test_fingerprints_survive_line_drift(tmp_path):
    result = run_analysis(_CONFIGS["hostsync"], ["hostsync_tp.py"])
    known = {(f.rule, f.path, f.fingerprint) for f in result.findings}
    shifted = tmp_path / "hostsync_tp.py"
    shifted.write_text("# a new header comment\n\n\n"
                       + (FIXTURES / "hostsync_tp.py").read_text())
    cfg = AnalysisConfig(root=str(tmp_path), index_globs=("*.py",),
                         hostsync_hot={"hostsync_tp.py": ("*._decode_live",)})
    moved = run_analysis(cfg, ["hostsync_tp.py"])
    new, old = baseline_mod.partition(moved.findings, known)
    assert new == [] and len(old) == len(moved.findings) == 11


# -- parity with the reference checker ------------------------------------------
def _variants(text, line):
    """The fixture as is, shifted down by a header, and, where ``line``
    holds a finding, that line suppressed and the whole file suppressed."""
    out = {"as_is": text, "shifted": "# header\n\n" + text}
    if line is not None:
        lines = text.splitlines()
        lines[line - 1] += "  # repro-lint: disable=OBS-GATE,DEPRECATION"
        out["line_suppressed"] = "\n".join(lines) + "\n"
        out["file_suppressed"] = "# repro-lint: disable-file=all\n" + text
    return out


def _assert_same(ref, own):
    assert [f.as_dict() for f in own.findings] == \
        [f.as_dict() for f in ref.findings]
    assert (own.suppressed, own.files_checked) == \
        (ref.suppressed, ref.files_checked)
    assert render_json(own, own.findings, []) == \
        ref_render_json(ref, ref.findings, [])
    assert render_text(own, own.findings[1:], own.findings[:1]) == \
        ref_render_text(ref, ref.findings[1:], ref.findings[:1])


def _parity(tmp_path, src_dir, name, **fields):
    """Both checkers over a copy of ``src_dir`` with ``name`` in each of
    its variants: identical findings (rule, path, line, message, symbol,
    fingerprint), suppression counts and reports.  Returns the port's
    results by variant."""
    first = ref_run_analysis(RefConfig(root=str(src_dir), **fields),
                             [name]).findings
    out = {}
    for variant, text in _variants((src_dir / name).read_text(),
                                    first[0].line if first else None
                                    ).items():
        root = tmp_path / variant
        shutil.copytree(src_dir, root,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (root / name).write_text(text)
        ref = ref_run_analysis(RefConfig(root=str(root), **fields), [name])
        own = run_analysis(AnalysisConfig(root=str(root), **fields), [name])
        _assert_same(ref, own)
        out[variant] = own
    return out


@pytest.mark.parametrize("name,found", [("obsgate_tp.py", 1),
                                        ("obsgate_tn.py", 0)])
def test_obsgate_parity_with_reference(tmp_path, name, found):
    got = _parity(tmp_path, REF_FIXTURES, name, index_globs=("*.py",),
                  obsgate_hot={name: ("*._decode_live", "*._observe")})
    assert len(got["as_is"].findings) == len(got["shifted"].findings) == \
        found
    if found:
        assert (len(got["line_suppressed"].findings),
                got["line_suppressed"].suppressed) == (0, 1)
        assert got["file_suppressed"].suppressed == 1


def test_deprecation_parity_with_reference(tmp_path):
    got = _parity(tmp_path, REF_FIXTURES / "depr", "mod.py",
                  index_globs=("**/*.py",), deprecation_scope=("mod.py",),
                  test_globs=("tests/*.py",))
    assert len(got["as_is"].findings) == 2
    assert (len(got["line_suppressed"].findings),
            got["line_suppressed"].suppressed) == (1, 1)
    assert (len(got["file_suppressed"].findings),
            got["file_suppressed"].suppressed) == (0, 2)


# -- the dispatch-level host-sync check --------------------------------------------
@pytest.fixture(scope="module")
def tiny_step():
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config("tiny")
    params = model.init_params(cfg, seed=0, device="cpu")
    cache = model.init_cache(cfg, 2, 64, page_size=16, device="cpu")
    table = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]], dtype=torch.int32)
    args = (params, {"tokens": torch.tensor([[5], [7]], dtype=torch.int32)},
            {**cache, "page_table": table},
            torch.tensor([17, 3], dtype=torch.int32), cfg)
    return model.decode_step, args


def test_decode_step_issues_no_host_sync_on_cpu(tiny_step):
    step, args = tiny_step
    logits, _ = dispatch_tools.assert_no_host_syncs(step, *args)
    assert logits.shape[:2] == (2, 1) and torch.isfinite(logits).all()


@pytest.mark.parametrize("greedy_only,want_logprobs", [
    (False, True), (False, False), (True, True)])
def test_sample_tokens_issue_no_host_sync_on_cpu(greedy_only, want_logprobs):
    from repro_torch.serve import sampling
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 257)).astype(
        np.float32))
    greedy = sampling.SamplingParams.greedy()
    hot = greedy if greedy_only else sampling.SamplingParams(
        temperature=0.8, top_k=7, top_p=0.9)
    rows = [(hot, 11, 0), (greedy, 0, 0), (hot, 12, 5)]
    tensors = [torch.from_numpy(a) for a in sampling.stack(rows)]
    toks, *_ = dispatch_tools.assert_no_host_syncs(
        sampling.sample_tokens, logits, *tensors,
        want_logprobs=want_logprobs, greedy_only=greedy_only)
    assert toks.shape == (3,)


@pytest.mark.parametrize("plant,op", [
    (lambda x: x.sum().item(), "aten._local_scalar_dense.default"),
    (lambda x: torch.equal(x, x), "aten.equal.default"),
    (lambda x: x[x > 0], "aten.index.Tensor"),
])
def test_planted_syncs_are_rejected(tiny_step, plant, op):
    step, args = tiny_step

    def planted(*a):
        logits, cache = step(*a)
        plant(logits)
        return logits, cache

    found = dispatch_tools.host_sync_ops(planted, *args)
    assert [s.op for s in found] == [op]
    assert "test_torch_analysis.py" in found[0].frame
    with pytest.raises(AssertionError, match=op.replace(".", r"\.")):
        dispatch_tools.assert_no_host_syncs(planted, *args)
    dispatch_tools.assert_no_host_syncs(planted, *args, allow=[op])


def test_own_frames_and_excluded_files():
    """A sync issued in a port module is reported at that module's line;
    the files ``exclude`` names are outside the check (by default the
    plain versions, ``kernels/ref.py``)."""
    from repro_torch.serve import sampling
    hit = dispatch_tools.host_sync_ops(sampling.branch_seed, 5, 1)
    assert [s.op for s in hit] == ["aten._local_scalar_dense.default"]
    assert hit[0].frame.startswith("repro_torch/serve/sampling.py:")
    assert hit[0].frame.endswith("(branch_seed)")
    assert dispatch_tools.host_sync_ops(
        sampling.branch_seed, 5, 1, exclude=("serve/sampling.py",)) == []
    assert dispatch_tools.DEFAULT_EXCLUDE == ("kernels/ref.py",)
