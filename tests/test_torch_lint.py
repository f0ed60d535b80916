"""The reference's own lint (``smg_tpu.analysis``, ``smglint``) over the
port: ``smg_tpu_torch/`` lints clean with an empty baseline, as
``tests/test_analysis.py`` holds ``smg_tpu/`` clean.  Every finding the lint
reports there is suppressed at its line with a reason (the reference's own
suppressions where the port copies the code, the runtime guards' benign
pre-check).

Run: ``python -m pytest tests/test_torch_lint.py -q``, or the lint alone:
``python -m smg_tpu.analysis.cli --no-baseline smg_tpu_torch``."""

import re
import subprocess
import sys
from pathlib import Path

from smg_tpu.analysis import lint_paths
from smg_tpu.analysis.rules import ALL_RULES

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "smg_tpu_torch"


def test_the_port_lints_clean_with_an_empty_baseline():
    r = subprocess.run([sys.executable, "-m", "smg_tpu.analysis.cli", "--no-baseline",
                        "smg_tpu_torch"], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s), 0 baselined" in r.stdout, r.stdout


def test_every_finding_is_suppressed_with_a_reason():
    findings = lint_paths([PORT])
    assert findings, "the lint found nothing to look at"
    assert [f for f in findings if not f.suppressed] == []
    for f in findings:
        line = (REPO / f.path).read_text().splitlines()
        text = " ".join(line[max(f.line - 2, 0):max(f.end_line, f.line)])
        m = re.search(rf"smglint: disable(?:-next)?={f.rule}\s+(\S.*)", text)
        assert m and len(m.group(1).split()) >= 2, (f.path, f.line, text)
    assert {f.rule for f in findings} <= set(ALL_RULES)
