"""Sharded checkpoints on ``torch.distributed.checkpoint``.

Counterpart of ``adaptive_classifier_tpu/parallel/checkpoint.py`` (orbax
there).  ``save_sharded`` writes a nested dict of tensors and
``DTensor``s with each rank writing its own shards (no gather to one
rank); ``restore_sharded`` reads it onto the placements of a template
with the same keys: a state saved from several ranks restores in one
process (plain tensors, no process group) or onto another mesh.  The
classifier's own save (``persistence.py``) stays the interchange format.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch.distributed as dist
import torch.distributed.checkpoint as dcp


def _single_process() -> bool:
    return not (dist.is_available() and dist.is_initialized())


def save_sharded(path, state: Any) -> None:
    """Write ``state`` (a nested dict of tensors / ``DTensor``s) under
    ``path``, every rank its own shards."""
    dcp.save(state, checkpoint_id=str(Path(path).resolve()), no_dist=_single_process())


def restore_sharded(path, template: Any) -> Any:
    """``template`` with its tensors filled from the checkpoint, in place,
    and returned: plain tensors take the whole saved value, ``DTensor``s
    this rank's slice under their own placements.  The keys and global
    shapes must match the saved state's."""
    dcp.load(template, checkpoint_id=str(Path(path).resolve()), no_dist=_single_process())
    return template
