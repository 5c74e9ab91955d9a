"""Shared pieces of the benchmark's own tests (CPU; the ``gpu`` ones skip
without a card)."""

import pytest
import torch

from l3dbench import registry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_cell(name: str, views: int = 8, segments: int = 1200,
              keep: int = 600) -> dict:
    """A cell of ``BENCHMARK.json`` cut to a CPU test's size: the first
    ``views`` views with ``segments`` cached segments each, ``keep`` kept
    a view, 20 LM iterations; its limits are the cell's own."""
    cell = registry.cell(name)
    cell["config"] = dict(cell["config"], views_used=views,
                          segments_used=segments)
    cell["spec"] = dict(cell["spec"], trace_scenes=2,
                        options=dict(cell["spec"]["options"],
                                     max_line_segments=keep,
                                     max_iter_optim=20))
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
