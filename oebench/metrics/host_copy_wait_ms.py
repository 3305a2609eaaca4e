"""host_copy_wait_ms (ms): host time a step of the batch's copy into the
step program's static buffers (``training.py`` ``_CapturedProgram._load``),
on the host's clock, over the steps the program counts
(``oebench/steps.py``). The batch lies in pageable memory, whose copy
waits for the card's previous step once the driver's staging buffer
fills, so this is that wait and the transfer together: it falls with the
copy's own cost and with the card's time a step alike."""

from oebench.steps import host_ms


def read(ctx):
    return host_ms(ctx, "copy")
