"""kspecanal_tpu_torch — the PyTorch/CUDA port of ``kspecanal_tpu``.

The JAX package ``kspecanal_tpu`` is the reference; this package mirrors its
layout module by module so each counterpart is found by name.  It imports
``torch`` and never ``jax``: the host-side modules of the reference that are
free of JAX (``config``, ``cli.parse_args``, ``io.sources``, ``io.replay``,
``utils``) are imported, not copied.  ``ops/peaks.py`` and
``render_term.py`` are copies, because importing the originals runs
``kspecanal_tpu/ops/__init__.py``, which imports JAX.

Every function takes its tensors on an explicit ``device``; the hand-written
CUDA kernels under ``csrc/`` run for tensors on a CUDA device, and their plain
PyTorch versions for tensors on the CPU.
"""

import torch  # noqa: F401

from kspecanal_tpu_torch.config import SpecConfig  # noqa: F401

__version__ = "0.1.0"
