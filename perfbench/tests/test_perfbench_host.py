"""The window's steps as the benchmark prints them on standard error:
their host times, to tell a level shift between runs from bursts inside
one run or a slow start."""
import tiny  # noqa: F401
from perfbench import harness


def test_step_lines():
    spans = harness.Spans()
    for i in range(25):
        spans.spans.append(("decode.step", 0.0, 0.1 + 0.001 * i))
    spans.spans.append(("setup.build", 0.0, 1.0))
    (line,) = harness.step_lines(spans)
    assert line.startswith("steps decode.step n=25 ms p10=102.4 p50=112.0 "
                           "p90=121.6 max=124.0 first20=[100.0 101.0 ")
    assert line.endswith("tenths=[100.5 103.0 105.5 108.0 110.5 113.0 115.5 "
                         "118.0 120.5 123.0]")


def test_step_lines_skip_spans_too_few_to_be_steps():
    spans = harness.Spans()
    spans.spans += [("score.step", 0.0, 3.0)] * 19
    assert harness.step_lines(spans) == []
    assert len(harness.step_lines(spans, least=19)) == 1
