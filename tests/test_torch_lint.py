"""The JAX package's static passes over the port: its lint
(``analysis.lint.lint_paths``) and its race analysis
(``analysis.concurrency.analyze_paths``) find nothing in
``paddle_tpu_torch/``. A finding that is provably not a fault is
suppressed in the source with a ``# pt-lint: disable=<code> <reason>``
comment, which both passes honour. The test imports the JAX package's
analysis; the port does not."""

import os

from paddle_tpu.analysis.concurrency import analyze_paths
from paddle_tpu.analysis.lint import lint_paths

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch")


def test_lint_finds_nothing_in_the_port():
    found = lint_paths([PORT])
    assert not found, "\n".join(str(d) for d in found)


def test_race_analysis_finds_nothing_in_the_port():
    found = analyze_paths([PORT])
    assert not found, "\n".join(str(d) for d in found)
