"""Atomic, async checkpoints in the reference's format."""
from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         read_manifest, restore, tree_paths)
