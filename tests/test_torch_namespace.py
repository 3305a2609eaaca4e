"""Torch port, the package surface against the JAX package's.

The port's top-level namespace holds every public name of
``openembedding_tpu/__init__.py`` under the same name, and
``interop.tensor_to_numpy`` (under every ``*_to_numpy``/``*_to_flax``)
hands back memory of its own: a CPU tensor updated in place after the
conversion leaves the converted array as it was. A CUDA graph capture
(``ops.launches``) holds the garbage collector off, which runs here on
the CPU.
"""

import types

import numpy as np
import pytest
import torch

import openembedding_tpu as oe
import openembedding_tpu_torch as ot
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.table import TableState


def _public(mod):
    """A package's public top-level names: its attributes that are not
    private and not one of its own submodules (``distributed`` is
    exported by name, so it counts), plus ``__version__``."""
    out = {"__version__"}
    for name in dir(mod):
        if name.startswith("_"):
            continue
        val = getattr(mod, name)
        if isinstance(val, types.ModuleType) and name != "distributed":
            continue
        out.add(name)
    return out


def test_jax_public_names_are_in_the_port():
    missing = sorted(_public(oe) - _public(ot))
    assert missing == []
    assert set(ot.__all__) <= set(dir(ot))
    assert ot.__version__ == oe.__version__
    assert ot.UNBOUNDED_VOCAB == oe.UNBOUNDED_VOCAB
    assert ot.META_FORMAT_VERSION == oe.META_FORMAT_VERSION
    assert ot.distributed.__name__ == "openembedding_tpu_torch.distributed"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_tensor_to_numpy_owns_its_memory(dtype):
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dtype)
    arr = interop.tensor_to_numpy(t)
    want = arr.copy()
    t.add_(5)
    t[0, 0] = 99
    np.testing.assert_array_equal(arr, want)
    if dtype == torch.bfloat16:
        assert arr.dtype == np.uint16
    weights, slots = interop.table_state_to_numpy(
        TableState(weights=t, slots={"accum": t.clone()}))
    before = weights.copy(), slots["accum"].copy()
    t.mul_(3)
    np.testing.assert_array_equal(weights, before[0])
    np.testing.assert_array_equal(slots["accum"], before[1])


def test_dense_params_to_flax_owns_its_memory():
    params = {"dnn.0.weight": torch.ones(2, 3), "dnn.0.bias": torch.ones(2)}
    tree = interop.dense_params_to_flax(params)
    params["dnn.0.bias"].add_(1.0)
    params["dnn.0.weight"].add_(1.0)
    np.testing.assert_array_equal(tree["dnn"]["0"]["bias"], np.ones(2))
    np.testing.assert_array_equal(tree["dnn"]["0"]["kernel"],
                                  np.ones((3, 2)))


def test_captures_hold_the_garbage_collector_off():
    """``ops.launches.gc_held`` (around every ``CountedGraph`` capture)
    disables cyclic collection for its body, across nested and
    concurrent holds, and restores the collector's state after the last;
    a collector that was off stays off."""
    import gc
    import threading
    from openembedding_tpu_torch.ops import launches
    assert gc.isenabled()
    inside, release = threading.Event(), threading.Event()

    def other():
        with launches.gc_held():
            inside.set()
            release.wait(10)
    t = threading.Thread(target=other)
    with launches.gc_held():
        assert not gc.isenabled()
        t.start()
        assert inside.wait(10)
        with launches.gc_held():
            assert not gc.isenabled()
    assert not gc.isenabled()       # the other thread still holds it
    release.set()
    t.join(10)
    assert gc.isenabled()
    gc.disable()
    try:
        with launches.gc_held():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
