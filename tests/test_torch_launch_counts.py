"""The hand kernels' launch counters, read and reset in one place.

``ddsp_tpu_torch.ops.cuda.COUNTERS`` names every wrapper's counter: a
kernel whose counter is missing there would escape every "no other hand
kernel launched" check.  CPU only: no kernel is launched here.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import importlib
import pkgutil

import pytest

from ddsp_tpu_torch.ops import cuda


def _counter_attrs():
    """(module, attribute) of every int ``*LAUNCHES`` in the wrapper modules."""
    found = set()
    for info in pkgutil.iter_modules(cuda.__path__):
        module = importlib.import_module(f"{cuda.__name__}.{info.name}")
        for attr, value in vars(module).items():
            if attr.endswith("LAUNCHES") and isinstance(value, int):
                found.add((info.name, attr))
    return found


def test_every_counter_is_listed():
    assert _counter_attrs() == set(cuda.COUNTERS.values())
    assert len(set(cuda.COUNTERS.values())) == len(cuda.COUNTERS)


@pytest.mark.parametrize("name", sorted(cuda.COUNTERS))
def test_counts_read_and_reset(name, monkeypatch):
    module_name, attr = cuda.COUNTERS[name]
    module = importlib.import_module(f"{cuda.__name__}.{module_name}")
    monkeypatch.setattr(module, attr, 3)
    counts = cuda.launch_counts()
    assert counts[name] == 3
    assert sum(counts.values()) == 3
    cuda.reset_launch_counts()
    assert getattr(module, attr) == 0
    assert not any(cuda.launch_counts().values())


def test_reset_clears_variant_counters():
    for module_name in cuda.VARIANT_COUNTERS:
        module = importlib.import_module(f"{cuda.__name__}.{module_name}")
        module.VARIANT_LAUNCHES["x"] += 2
    cuda.reset_launch_counts()
    for module_name in cuda.VARIANT_COUNTERS:
        module = importlib.import_module(f"{cuda.__name__}.{module_name}")
        assert not module.VARIANT_LAUNCHES
