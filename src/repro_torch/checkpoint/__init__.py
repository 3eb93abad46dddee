"""Reader of the reference's checkpoint format."""
from .checkpoint import latest_step, read_manifest, restore  # noqa: F401
