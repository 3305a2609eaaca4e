"""host_launch_ms (ms): host time a step of the step graph's launch
(``ops/launches.py`` ``CountedGraph.replay``), on the host's clock, over
the steps the program counts (``oebench/steps.py``)."""

from oebench.steps import host_ms


def read(ctx):
    return host_ms(ctx, "launch")
