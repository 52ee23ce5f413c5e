"""``bench.py``'s parent: it runs each section in a child process, on the
GPU only, and reports a section that fails or runs too long."""

import json

import bench


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]


def test_bench_section_fails_without_a_gpu(capsys):
    assert bench.main(["fwd"]) == 1
    first, merged = _lines(capsys)
    assert first == {"section": "fwd", "error": 1}
    assert merged["failed_sections"] == ["fwd"]


def test_bench_reports_a_section_past_its_time_limit(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SECTION_TIMEOUT_S", 0.01)
    assert bench.main(["fwd"]) == 1
    assert _lines(capsys)[0] == {"section": "fwd", "error": "timeout"}


def test_bench_rejects_unknown_sections():
    assert bench.main(["no_such_section"]) == 2
