"""host_step_ms (ms): host time a call of ``Trainer.train_step``
(``training.py``), on the host's clock, over the steps the program counts
(``oebench/steps.py``): what the host spends on a step, set against the
window's time a step."""

from oebench.steps import host_ms


def read(ctx):
    return host_ms(ctx, "step")
