"""The benchmark of ``openembedding_tpu_torch``, the PyTorch and CUDA
package of this repository.

One command runs one cell (one entry of ``workloads`` in the repository's
``BENCHMARK.json``) once::

    python3 -m oebench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it (:mod:`oebench.layout`):

* ``configs/<config>.json``: the sizes of a configuration as it is run;
* ``traffic/<mix>.json``: the parameters that :mod:`oebench.traffic`, the
  one general generator, reads;
* ``distributions/<dist>.py``: a distribution a mix names for its ids or
  dense features;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell, with the readings it was set from.

``reference/`` is the plain reference: PyTorch and NumPy only, it imports
nothing of the program; a configuration's ``model`` names its module there,
``reference/<model>.py``. Nothing here imports JAX or the JAX package.
"""
