"""More than one device: the view-sharded forward step on
``torch.distributed`` (``sharded``), and its multi-process runner
(``python -m line3dpp_tpu_torch.parallel.run``)."""

from . import sharded

__all__ = ["sharded"]
